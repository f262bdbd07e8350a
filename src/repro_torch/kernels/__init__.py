"""Hand-written Hopper kernels for the port's hot spots.

Each kernel is a subpackage with ``csrc/*.cu`` (the CUDA source, built by
``_build`` at first launch), ``kernel.py`` (the launcher), ``ops.py`` (the
public wrapper, which keeps the reference wrapper's contract) and ``ref.py``
(the plain torch version, taken for CPU tensors).

- fragment_gather — device-side assembly of differentially-cached fragments
  into a dense block (the device tier's UNION and merge replication).
"""

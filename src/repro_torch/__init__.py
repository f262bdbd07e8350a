"""repro_torch — the PyTorch/CUDA port of ``repro``.

It mirrors the reference package module for module: the lakehouse
(``lake``), the differential cache and its tiers (``core``), the declarative
pipeline (``pipeline``), observability (``obs``), static analysis
(``analysis``) and the hand-written Hopper kernels (``kernels``).  Modules
without framework code are kept as copies of the reference's; the rest run
on torch tensors.  Entry points run on the CUDA card unless the caller asks
for the CPU.

Importing this package loads no submodule.
"""

"""Hand-written Hopper kernels for the port's hot spots.

Each kernel is a subpackage with ``csrc/*.cu`` (the CUDA source, built by
``_build`` at first launch), ``kernel.py`` (the launcher), ``ops.py`` (the
public wrapper, which keeps the reference wrapper's contract) and ``ref.py``
(the plain torch version, taken for CPU tensors).

- fragment_gather — device-side assembly of differentially-cached fragments
  into a dense block (the device tier's UNION and merge replication).
- dequant — int8 pages with per-column scales decoded to bf16/f32 once, on
  the device (the columnar cache's decode-once economics).
- flash_attention — blocked online-softmax attention, the prefill hot spot
  of every attention layer (``models/layers.py``).
- mamba2_ssd — the chunked SSD scan of every Mamba2 layer's prefill
  (``models/ssm.py``).

The package exports the reference package's nine names.  Importing it
builds nothing: each library is built at its kernel's first launch.
"""

from repro_torch.kernels.dequant import dequant, dequant_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.fragment_gather import fragment_gather, gather_ref
from repro_torch.kernels.mamba2_ssd import ssd, ssd_ref_chunked, ssd_ref_sequential

__all__ = [
    "dequant", "dequant_ref",
    "flash_attention", "attention_ref",
    "fragment_gather", "gather_ref",
    "ssd", "ssd_ref_chunked", "ssd_ref_sequential",
]

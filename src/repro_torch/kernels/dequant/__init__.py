from repro_torch.kernels.dequant.ops import dequant
from repro_torch.kernels.dequant.ref import dequant_ref

__all__ = ["dequant", "dequant_ref"]

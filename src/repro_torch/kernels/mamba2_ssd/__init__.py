from repro_torch.kernels.mamba2_ssd.ops import ssd
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref_chunked, ssd_ref_sequential

__all__ = ["ssd", "ssd_ref_chunked", "ssd_ref_sequential"]

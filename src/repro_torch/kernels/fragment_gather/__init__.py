from repro_torch.kernels.fragment_gather.ops import fragment_gather
from repro_torch.kernels.fragment_gather.ref import gather_ref

__all__ = ["fragment_gather", "gather_ref"]

from repro_torch.kernels.fragment_gather.ops import fragment_gather, fragment_union
from repro_torch.kernels.fragment_gather.ref import gather_ref, union_ref

__all__ = ["fragment_gather", "fragment_union", "gather_ref", "union_ref"]

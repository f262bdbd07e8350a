from repro_torch.serve.engine import GenerateRequest, GenerateResult, ServeEngine
from repro_torch.serve.sampling import sample_token

__all__ = ["ServeEngine", "GenerateRequest", "GenerateResult", "sample_token"]

"""``repro_torch.analysis`` — static contract verification & column-scope
inference for ``@model`` functions (the substrate for narrowed cache
signatures, plan-time scope enforcement, and ``python -m repro_torch.lint``).

Deliberately import-light: ``repro_torch.pipeline`` imports this package at
decoration time, so nothing here may import ``repro_torch.pipeline`` back.
"""

from repro_torch.analysis.errors import (
    CROSS_ROW_OP,
    HIDDEN_STATE,
    NONDETERMINISM,
    SCOPE_MISMATCH,
    UNDECLARED_READ,
    VIOLATION_CODES,
    ContractError,
    Finding,
    ScopeViolation,
)
from repro_torch.analysis.walker import (
    UNKNOWN,
    Analysis,
    analyze_code,
    analyze_model_fn,
    is_user_function,
    referenced_functions,
)

__all__ = [
    "CROSS_ROW_OP",
    "NONDETERMINISM",
    "HIDDEN_STATE",
    "SCOPE_MISMATCH",
    "UNDECLARED_READ",
    "VIOLATION_CODES",
    "Finding",
    "ContractError",
    "ScopeViolation",
    "UNKNOWN",
    "Analysis",
    "analyze_code",
    "analyze_model_fn",
    "is_user_function",
    "referenced_functions",
]

"""Finding codes and error types for the static contract verifier.

Finding codes are STABLE — lint output, CI gates, and tests key on them:

- ``RPR001`` cross-row operation inside an ``incremental="rowwise"`` body
  (sort/argsort/cumsum/shift/diff/reduceat-style calls; keyed reducers
  legitimately see whole groups, so the check applies to rowwise only).
- ``RPR002`` nondeterminism (``random``, value-producing ``time`` calls,
  ``uuid``, unseeded jax PRNG): warm≠cold is guaranteed, caching unsound.
- ``RPR003`` hidden state (STORE_GLOBAL, mutation of captured objects):
  the output depends on data the code fingerprint cannot see.
- ``RPR004`` scope mismatch: proven column writes (or a plan's requested
  columns) contradict the ``writes=``/``reads=`` declaration.
- ``RPR005`` undeclared read: analysis proves the function reads a column
  its ``reads=`` declaration does not cover.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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
]

CROSS_ROW_OP = "RPR001"
NONDETERMINISM = "RPR002"
HIDDEN_STATE = "RPR003"
SCOPE_MISMATCH = "RPR004"
UNDECLARED_READ = "RPR005"

# codes that make an incremental declaration unsound (dag-time errors);
# RPR004/RPR005 are declaration mismatches raised at decoration time
VIOLATION_CODES = (CROSS_ROW_OP, NONDETERMINISM, HIDDEN_STATE)


@dataclass(frozen=True)
class Finding:
    """One lint finding, anchored to the instruction's source line."""

    code: str
    message: str
    filename: str
    lineno: int
    model: Optional[str] = None
    helper: Optional[str] = None  # qualname of the helper it was found in

    def location(self) -> str:
        return f"{self.filename}:{self.lineno}"

    def render(self) -> str:
        where = f" (in helper {self.helper})" if self.helper else ""
        who = f" model {self.model!r}" if self.model else ""
        return f"{self.location()}: {self.code}{who}: {self.message}{where}"


class ContractError(ValueError):
    """A model's declared contract is provably violated (or malformed).

    Subclasses ``ValueError`` so every pre-existing ``pytest.raises(
    ValueError)`` over compile-time contract failures keeps passing.
    Carries the model name and ``file:line`` whenever they are known —
    bare declaration errors (``incremental="columnar"`` before any
    function exists) have neither.
    """

    def __init__(
        self,
        message: str,
        *,
        model: Optional[str] = None,
        filename: Optional[str] = None,
        lineno: Optional[int] = None,
        findings: Optional[List[Finding]] = None,
    ):
        self.model = model
        self.filename = filename
        self.lineno = lineno
        self.findings = list(findings or [])
        prefix = ""
        if filename is not None and lineno is not None:
            prefix = f"{filename}:{lineno}: "
        if model is not None:
            prefix += f"model {model!r}: "
        super().__init__(prefix + message)


class ScopeViolation(ContractError):
    """A plan requests columns outside a node's verified/declared read
    scope — raised at plan time, before any byte is read (RPR004)."""

    code = SCOPE_MISMATCH

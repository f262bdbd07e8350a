"""Static discovery of ``@model`` functions that only exist *inside*
factories (``def make_project(hi): ... @model(project=p, ...) def f(...)``)
— the dominant idiom in this repo's tests and examples, where the factory
is never called at import time.

The scan walks module-level function bytecode looking for calls to a name
``model`` made with keyword arguments (``CALL_FUNCTION_KW``), extracts the
constant ``incremental=`` / ``name=`` / ``reads=`` / ``writes=`` /
``verify=`` kwargs when they are literal constants, and associates the
call with the next ``MAKE_FUNCTION``'s code object — the function being
decorated (decorators apply innermost-first, so the body's code const is
pushed after the factory call).  Anything it cannot decode it skips:
missing a model here only loses lint coverage, it can never produce a
false finding.
"""

from __future__ import annotations

import dis
import types
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.walker import _instructions

__all__ = ["NestedModel", "iter_nested_models"]


@dataclass
class NestedModel:
    code: types.CodeType
    incremental: str
    name: str
    reads: Optional[Tuple[str, ...]]
    writes: Optional[Tuple[str, ...]]
    verify: bool


def _const_kwargs(
    ins: List[dis.Instruction], i: int, argc: int
) -> Optional[Dict[str, Any]]:
    """Decode the kwargs of ``CALL_FUNCTION_KW`` at index ``i`` IF every
    keyword value is a single-instruction push (consts and simple loads);
    multi-instruction values (f-strings, ``Model(...)`` calls) shift the
    stack layout and make positions unrecoverable — return None."""
    names_instr = ins[i - 1]
    if names_instr.opname != "LOAD_CONST" or not isinstance(
        names_instr.argval, tuple
    ):
        return None
    names = names_instr.argval
    if len(names) != argc or i - 1 - argc < 0:
        return None
    callee = ins[i - 2 - argc]
    if (
        callee.opname not in ("LOAD_GLOBAL", "LOAD_DEREF", "LOAD_FAST")
        or callee.argval != "model"
    ):
        return None
    values = ins[i - 1 - argc : i - 1]
    out: Dict[str, Any] = {}
    for nm, v in zip(names, values):
        out[nm] = v.argval if v.opname == "LOAD_CONST" else None
    return out


def _nested_models_in(code: types.CodeType) -> Iterator[NestedModel]:
    ins = _instructions(code)
    pending: Optional[Dict[str, Any]] = None
    for i, instr in enumerate(ins):
        if instr.opname == "CALL_FUNCTION_KW":
            kw = _const_kwargs(ins, i, instr.arg or 0)
            if kw is not None:
                pending = kw
        elif instr.opname == "MAKE_FUNCTION" and pending is not None:
            # the code const sits right before MAKE_FUNCTION (after the
            # qualname const on 3.10 it's code, qualname, MAKE_FUNCTION)
            body = None
            for back in (1, 2):
                cand = ins[i - back] if i - back >= 0 else None
                if (
                    cand is not None
                    and cand.opname == "LOAD_CONST"
                    and isinstance(cand.argval, types.CodeType)
                ):
                    body = cand.argval
                    break
            if body is not None:
                inc = kw_str(pending, "incremental", "none")
                reads = kw_tuple(pending, "reads")
                writes = kw_tuple(pending, "writes")
                verify = pending.get("verify", True)
                yield NestedModel(
                    code=body,
                    incremental=inc,
                    name=kw_str(pending, "name", body.co_name),
                    reads=reads,
                    writes=writes,
                    verify=verify if isinstance(verify, bool) else True,
                )
            pending = None
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            yield from _nested_models_in(const)


def kw_str(kw: Dict[str, Any], key: str, default: str) -> str:
    v = kw.get(key, default)
    return v if isinstance(v, str) else default


def kw_tuple(kw: Dict[str, Any], key: str) -> Optional[Tuple[str, ...]]:
    v = kw.get(key)
    if isinstance(v, tuple) and all(isinstance(x, str) for x in v):
        return v
    return None


def iter_nested_models(module: types.ModuleType) -> Iterator[NestedModel]:
    """All statically discoverable ``@model(...)``-decorated code objects
    under ``module``'s module-level functions."""
    seen: set = set()
    for obj in vars(module).values():
        if (
            isinstance(obj, types.FunctionType)
            and getattr(obj, "__module__", None) == module.__name__
        ):
            for nm in _nested_models_in(obj.__code__):
                if nm.code not in seen:
                    seen.add(nm.code)
                    yield nm

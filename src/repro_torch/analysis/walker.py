"""A conservative bytecode walker over ``@model`` function code objects.

Two jobs, one pass:

1. **Contract verdict** — for ``incremental="rowwise"``/``"keyed"``
   functions, find operations that falsify the declaration *before* any
   execution: cross-row ops in rowwise bodies (RPR001), nondeterminism
   (RPR002), hidden state (RPR003).  The walk recurses into nested code
   objects in ``co_consts`` (comprehensions, lambdas, nested defs) and
   transitively into module-level helper *functions* resolved via
   ``co_names`` → ``__globals__`` / closure cells — library code
   (stdlib / site-packages) is never descended into, so numpy's own
   internals can't produce findings.

2. **Column scope** — the set of constant column keys the function reads
   from its table parameters (``data["x"]``, ``data.column("x")``,
   ``data.get("x", …)``) and the constant keys it writes (dict-literal /
   ``out["k"] = …`` outputs).  Whenever the analysis cannot PROVE a bound
   — a table escapes into a call, a dynamic key, ``.items()``, aliasing it
   can't follow — the result is the :data:`UNKNOWN` sentinel and every
   consumer falls back to today's behavior.  Sound by construction: a
   proven read set is always a superset of the columns the function can
   actually distinguish.

Everything here is best-effort *except* the soundness direction: the
walker may say UNKNOWN when a human could prove a bound, and it may
report a violation a human could argue away (conservatism), but it must
never prove a scope smaller than the truth — cached windows are reused
on the strength of it.
"""

from __future__ import annotations

import dis
import os
import sys
import types
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

from repro_torch.analysis.errors import (
    CROSS_ROW_OP,
    HIDDEN_STATE,
    NONDETERMINISM,
    Finding,
)

__all__ = [
    "UNKNOWN",
    "Analysis",
    "analyze_code",
    "analyze_model_fn",
    "referenced_functions",
    "is_user_function",
]


class _Unknown:
    """Sentinel: analysis could not prove a bound — fall back to today's
    behavior (full-column signatures, no narrowing, no enforcement)."""

    _instance: Optional["_Unknown"] = None

    def __new__(cls) -> "_Unknown":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "UNKNOWN"

    def __bool__(self) -> bool:
        return False


UNKNOWN = _Unknown()

Scope = Union[FrozenSet[str], _Unknown]


@dataclass
class Analysis:
    """The walker's verdict for one model function."""

    findings: List[Finding] = field(default_factory=list)
    reads: Scope = UNKNOWN
    writes: Scope = UNKNOWN

    @property
    def violations(self) -> List[Finding]:
        from repro_torch.analysis.errors import VIOLATION_CODES

        return [f for f in self.findings if f.code in VIOLATION_CODES]


_MISSING = object()

# ---------------------------------------------------------------- rule tables

# RPR001 — operations whose output row i depends on input rows != i.
# Name-based (attribute/method/global), rowwise bodies only: keyed reducers
# see whole key groups and legitimately diff/reduceat/unique within them.
_CROSS_ROW_NAMES = frozenset(
    {
        "sort", "argsort", "lexsort", "msort", "sort_complex",
        "sort_values", "sort_index", "partition", "argpartition",
        "cumsum", "cumprod", "nancumsum", "nancumprod", "cumulative_sum",
        "cummax", "cummin",
        "shift", "diff", "ediff1d", "gradient",
        "convolve", "correlate",
        "reduceat", "accumulate",
        "rolling", "expanding", "ewm",
    }
)

# RPR002 — value-producing time functions (sleep is timing, not a value:
# corpus fixtures sleep to exercise coalescing and stay deterministic)
_TIME_VALUE_FNS = frozenset(
    {
        "time", "time_ns", "perf_counter", "perf_counter_ns",
        "monotonic", "monotonic_ns", "process_time", "process_time_ns",
        "thread_time", "thread_time_ns", "clock_gettime", "clock_gettime_ns",
        "localtime", "gmtime", "ctime", "asctime", "strftime", "mktime",
    }
)
_UUID_NONDET = frozenset({"uuid1", "uuid4", "getnode"})
# numpy.random names that are deterministic handles/classes rather than
# draws from the hidden global BitGenerator; default_rng/RandomState are
# fine ONLY with a constant seed (checked at the call site)
_NP_RANDOM_OK = frozenset(
    {
        "default_rng", "Generator", "RandomState", "SeedSequence",
        "BitGenerator", "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
    }
)
_SEEDED_FACTORIES = frozenset({"default_rng", "RandomState", "PRNGKey", "key"})

# RPR003 — in-place mutator methods; called on a captured (global / closure)
# object they leak state across runs.  Module bases are exempt (np.append).
_MUTATORS = frozenset(
    {
        "append", "extend", "insert", "remove", "pop", "popitem", "clear",
        "update", "setdefault", "add", "discard", "reverse",
        "appendleft", "extendleft", "popleft", "write", "writelines",
    }
)

# table-parameter attributes that cannot observe column *values* or the
# column set (row count depends on window+filter only) — reading them does
# not widen the scope and does not force UNKNOWN
_NEUTRAL_TABLE_ATTRS = frozenset({"num_rows"})

_NAME_LOADS = ("LOAD_GLOBAL", "LOAD_DEREF", "LOAD_CLASSDEREF")
_ATTR_LOADS = ("LOAD_ATTR", "LOAD_METHOD")

# Every pattern below (LOAD_METHOD call pairs, LOAD_FAST/LOAD_CONST/
# BINARY_SUBSCR subscript triples) is the CPython 3.10/3.11 compiler's
# shape.  3.12 stops emitting LOAD_METHOD and 3.13 fuses loads into
# LOAD_FAST_LOAD_FAST, which would silently blind both the contract
# checks and the scope pass — reads would stay "proven" while missing
# real column loads.  Outside the tested range the analyzer abstains
# entirely: no findings, every scope UNKNOWN, callers fall back to
# pre-analysis behavior.
_SUPPORTED_INTERPRETER = (
    sys.implementation.name == "cpython"
    and (3, 10) <= sys.version_info[:2] <= (3, 11)
)

_MAX_HELPER_DEPTH = 8
_MAX_CODES = 256
_MAX_SCOPE_PASSES = 8


def is_user_function(fn: Any) -> bool:
    """True for functions defined in user land — i.e. NOT the stdlib and
    NOT an installed package.  numpy/jax helpers are Python functions too;
    descending into them would flag their internals (they sort, seed, and
    cache freely) and hash megabytes of library code into fingerprints."""
    if not isinstance(fn, types.FunctionType):
        return False
    mod = sys.modules.get(getattr(fn, "__module__", None) or "")
    path = getattr(mod, "__file__", None)
    if path is None:  # __main__, exec()'d namespaces, builtins
        return True
    path = os.path.abspath(path)
    if "site-packages" in path or "dist-packages" in path:
        return False
    return not path.startswith(os.path.dirname(os.path.abspath(os.__file__)))


def _instructions(code: types.CodeType) -> List[dis.Instruction]:
    return [
        i
        for i in dis.get_instructions(code)
        if i.opname not in ("EXTENDED_ARG", "NOP", "RESUME", "PRECALL", "CACHE")
    ]


class _Walker:
    def __init__(
        self,
        *,
        mode: str,
        model: Optional[str],
        table_params: Sequence[str],
    ):
        self.mode = mode
        self.model = model
        self.findings: List[Finding] = []
        self.reads: set = set()
        self.reads_unknown = False
        self.writes: set = set()
        self.writes_unknown = False
        self.tables = set(table_params)
        self._seen_codes: set = set()
        self._seen_findings: set = set()
        self._helpers: List[Tuple[types.FunctionType, int]] = []
        self._seen_helper_codes: set = set()
        self._codes_walked = 0

    # -- findings -------------------------------------------------------------
    def _flag(
        self,
        code: str,
        message: str,
        filename: str,
        lineno: int,
        helper: Optional[str] = None,
    ) -> None:
        key = (code, filename, lineno, message)
        if key in self._seen_findings:
            return
        self._seen_findings.add(key)
        self.findings.append(
            Finding(
                code=code,
                message=message,
                filename=filename,
                lineno=lineno,
                model=self.model,
                helper=helper,
            )
        )

    # -- env resolution -------------------------------------------------------
    def _resolve_chain(
        self,
        ins: List[dis.Instruction],
        env: Dict[str, Any],
        local_env: Dict[str, Any],
    ) -> List[Any]:
        """res[i] = the object instruction ``i`` pushes, when it is a
        *resolvable named thing*: a global/closure name, a local holding an
        import, a constant, or an attribute chain rooted at a module (and
        one level of class attributes for ``datetime.datetime.now``-style
        chains).  Everything else is ``_MISSING``."""
        res: List[Any] = [_MISSING] * len(ins)
        for i, instr in enumerate(ins):
            op = instr.opname
            if op == "LOAD_CONST":
                res[i] = instr.argval
            elif op == "LOAD_GLOBAL" or op in ("LOAD_DEREF", "LOAD_CLASSDEREF"):
                res[i] = env.get(instr.argval, _MISSING)
            elif op == "LOAD_FAST":
                res[i] = local_env.get(instr.argval, _MISSING)
            elif op == "IMPORT_NAME":
                # never import on the walker's behalf: resolve only modules
                # the process has already loaded
                res[i] = sys.modules.get(instr.argval, _MISSING)
            elif op == "IMPORT_FROM":
                base = res[i - 1] if i else _MISSING
                if isinstance(base, types.ModuleType):
                    sub = sys.modules.get(f"{base.__name__}.{instr.argval}")
                    res[i] = (
                        sub
                        if sub is not None
                        else getattr(base, instr.argval, _MISSING)
                    )
            elif op in _ATTR_LOADS:
                base = res[i - 1] if i else _MISSING
                if isinstance(base, (types.ModuleType, type)):
                    res[i] = getattr(base, instr.argval, _MISSING)
            elif op == "STORE_FAST":
                v = res[i - 1] if i else _MISSING
                if isinstance(v, (types.ModuleType, types.FunctionType)):
                    local_env[instr.argval] = v
                else:
                    local_env.pop(instr.argval, None)
        return res

    # -- RPR002 ---------------------------------------------------------------
    def _const_seeded(self, ins: List[dis.Instruction], i: int) -> bool:
        """``default_rng``/``PRNGKey`` loaded at ``i``: seeded iff the first
        argument is a literal constant number."""
        if i + 1 < len(ins) and ins[i + 1].opname == "LOAD_CONST":
            return isinstance(ins[i + 1].argval, (int, float))
        return False

    def _nondet_attr(
        self, owner: str, attr: str, ins: List[dis.Instruction], i: int
    ) -> Optional[str]:
        """owner = module name (or bare base name when unresolvable)."""
        if owner == "random" or owner.startswith("random."):
            return f"random.{attr} draws from the global PRNG"
        if owner in ("numpy.random", "np.random") or owner.startswith(
            "numpy.random."
        ):
            if attr in _SEEDED_FACTORIES:
                if not self._const_seeded(ins, i):
                    return f"numpy.random.{attr} without a constant seed"
                return None
            if attr in _NP_RANDOM_OK:
                return None
            return f"numpy.random.{attr} draws from the global BitGenerator"
        if owner == "time":
            if attr in _TIME_VALUE_FNS:
                return f"time.{attr} reads the clock"
            return None
        if owner == "uuid" and attr in _UUID_NONDET:
            return f"uuid.{attr} is nondeterministic"
        if owner == "secrets" or owner.startswith("secrets."):
            return f"secrets.{attr} draws from the OS entropy pool"
        if owner == "os" and attr in ("urandom", "getrandom"):
            return f"os.{attr} draws from the OS entropy pool"
        if owner == "jax.random" and attr in _SEEDED_FACTORIES:
            if not self._const_seeded(ins, i):
                return f"jax.random.{attr} without a constant seed"
            return None
        if owner == "datetime" and attr in ("now", "today", "utcnow"):
            return f"datetime.{attr} reads the clock"
        return None

    def _check_nondet_direct(self, obj: Any, instr: dis.Instruction) -> Optional[str]:
        """A directly-loaded name resolving to a library callable, e.g.
        ``from random import random`` / ``from time import time``."""
        if not isinstance(
            obj, (types.FunctionType, types.BuiltinFunctionType, types.MethodType)
        ):
            return None
        mod = getattr(obj, "__module__", None) or ""
        name = getattr(obj, "__name__", instr.argval)
        if mod == "random" or mod.startswith("random."):
            return f"random.{name} draws from the global PRNG"
        if mod.startswith("numpy.random") and name not in _NP_RANDOM_OK:
            return f"numpy.random.{name} draws from the global BitGenerator"
        if mod == "time" and name in _TIME_VALUE_FNS:
            return f"time.{name} reads the clock"
        if mod == "uuid" and name in _UUID_NONDET:
            return f"uuid.{name} is nondeterministic"
        if mod == "secrets" or mod.startswith("secrets."):
            return f"secrets.{name} draws from the OS entropy pool"
        return None

    # -- one code object ------------------------------------------------------
    def walk_code(
        self,
        code: types.CodeType,
        env: Dict[str, Any],
        *,
        infer_scope: bool,
        helper: Optional[str] = None,
        depth: int = 0,
    ) -> None:
        if code in self._seen_codes:
            return
        if self._codes_walked >= _MAX_CODES:
            # budget exhausted: unscanned code could read/write anything
            if infer_scope:
                self.reads_unknown = True
                self.writes_unknown = True
            return
        self._seen_codes.add(code)
        self._codes_walked += 1

        ins = _instructions(code)
        local_env: Dict[str, Any] = {}
        res = self._resolve_chain(ins, env, local_env)
        filename = code.co_filename
        line = code.co_firstlineno
        verify = self.mode in ("rowwise", "keyed")

        for i, instr in enumerate(ins):
            if instr.starts_line is not None:
                line = instr.starts_line
            op = instr.opname
            prev = ins[i - 1] if i else None
            base = res[i - 1] if i else _MISSING

            # ---- contract checks (rowwise/keyed only) ----
            if verify:
                # RPR001: cross-row ops falsify rowwise (keyed reducers see
                # whole groups; their leakage is checked at runtime instead)
                if (
                    self.mode == "rowwise"
                    and op in _ATTR_LOADS + ("LOAD_GLOBAL", "IMPORT_FROM")
                    and instr.argval in _CROSS_ROW_NAMES
                ):
                    self._flag(
                        CROSS_ROW_OP,
                        f"{instr.argval!r} is a cross-row operation: output "
                        f"row i would depend on other rows, which "
                        f"incremental='rowwise' forbids",
                        filename,
                        line,
                        helper,
                    )
                # RPR002: nondeterminism
                if op in _ATTR_LOADS or op == "IMPORT_FROM":
                    owner = None
                    if isinstance(base, types.ModuleType):
                        owner = base.__name__
                    elif isinstance(base, type) and base.__module__ == "datetime":
                        owner = "datetime"
                    elif (
                        base is _MISSING
                        and prev is not None
                        and prev.opname in _NAME_LOADS + ("LOAD_FAST",)
                        and prev.argval in ("random", "time", "uuid", "secrets")
                    ):
                        owner = prev.argval  # unresolvable import, name-keyed
                    if owner is not None:
                        why = self._nondet_attr(owner, instr.argval, ins, i)
                        if why:
                            self._flag(
                                NONDETERMINISM,
                                f"{why}: warm and cold runs would diverge",
                                filename,
                                line,
                                helper,
                            )
                if op in _NAME_LOADS and res[i] is not _MISSING:
                    why = self._check_nondet_direct(res[i], instr)
                    if why:
                        self._flag(
                            NONDETERMINISM,
                            f"{why}: warm and cold runs would diverge",
                            filename,
                            line,
                            helper,
                        )
                # RPR003: hidden state
                if op in ("STORE_GLOBAL", "DELETE_GLOBAL"):
                    self._flag(
                        HIDDEN_STATE,
                        f"writes global {instr.argval!r}: output would depend "
                        f"on state outside the declared inputs",
                        filename,
                        line,
                        helper,
                    )
                if (
                    op == "LOAD_METHOD"
                    and instr.argval in _MUTATORS
                    and prev is not None
                    and prev.opname in _NAME_LOADS
                    and not isinstance(base, types.ModuleType)
                ):
                    self._flag(
                        HIDDEN_STATE,
                        f"mutates captured object {prev.argval!r} via "
                        f".{instr.argval}(): state leaks across runs",
                        filename,
                        line,
                        helper,
                    )
                if (
                    op in ("STORE_ATTR", "DELETE_ATTR")
                    and prev is not None
                    and prev.opname in _NAME_LOADS
                ):
                    self._flag(
                        HIDDEN_STATE,
                        f"assigns attribute on captured object "
                        f"{prev.argval!r}: state leaks across runs",
                        filename,
                        line,
                        helper,
                    )
                if (
                    op in ("STORE_SUBSCR", "DELETE_SUBSCR")
                    and i >= 2
                    and ins[i - 2].opname in _NAME_LOADS
                ):
                    self._flag(
                        HIDDEN_STATE,
                        f"assigns into captured object "
                        f"{ins[i - 2].argval!r}: state leaks across runs",
                        filename,
                        line,
                        helper,
                    )

            # ---- transitive helpers (user functions only) ----
            if (
                op in _NAME_LOADS
                and is_user_function(res[i])
                and depth < _MAX_HELPER_DEPTH
            ):
                h = res[i]
                if h.__code__ not in self._seen_helper_codes:
                    self._seen_helper_codes.add(h.__code__)
                    self._helpers.append((h, depth + 1))

            # ---- column-scope inference ----
            if not infer_scope:
                continue
            if op in ("LOAD_FAST", "LOAD_DEREF") and instr.argval in self.tables:
                nxt = ins[i + 1] if i + 1 < len(ins) else None
                nx2 = ins[i + 2] if i + 2 < len(ins) else None
                if nxt is None:
                    self.reads_unknown = True
                elif (
                    nxt.opname == "LOAD_CONST"
                    and isinstance(nxt.argval, str)
                    and nx2 is not None
                    and nx2.opname == "BINARY_SUBSCR"
                ):
                    self.reads.add(nxt.argval)
                elif (
                    nxt.opname in _ATTR_LOADS
                    and nxt.argval in ("column", "get")
                    and nx2 is not None
                    and nx2.opname == "LOAD_CONST"
                    and isinstance(nx2.argval, str)
                ):
                    self.reads.add(nx2.argval)
                elif nxt.opname == "LOAD_ATTR" and nxt.argval in _NEUTRAL_TABLE_ATTRS:
                    pass
                elif nxt.opname == "STORE_FAST":
                    # alias: track it as a table too (over-approximates if
                    # the local is later rebound — that only ADDS reads or
                    # forces UNKNOWN, never shrinks the scope)
                    self.tables.add(nxt.argval)
                else:
                    # the table escapes: into a call, a non-const key,
                    # .filter/.items/.column_names, a return — unprovable
                    self.reads_unknown = True
            elif op == "STORE_FAST" and instr.argval in self.tables:
                # something non-table rebinds an alias name; keep it in
                # `tables` (over-approximation is the safe direction) but
                # note we can no longer prove the read set is tight enough
                # to matter — leave as-is; reads stay a superset.
                pass

            # ---- column writes (best effort) ----
            if op == "BUILD_CONST_KEY_MAP" and prev is not None:
                keys = prev.argval if prev.opname == "LOAD_CONST" else None
                if isinstance(keys, tuple) and all(
                    isinstance(k, str) for k in keys
                ):
                    self.writes.update(keys)
                else:
                    self.writes_unknown = True
            elif op == "STORE_SUBSCR":
                key = ins[i - 1] if i >= 1 else None
                if (
                    i >= 2
                    and ins[i - 2].opname == "LOAD_FAST"
                    and key.opname == "LOAD_CONST"
                    and isinstance(key.argval, str)
                ):
                    self.writes.add(key.argval)
                else:
                    # augmented assigns (… ROT_THREE STORE_SUBSCR), stores
                    # through non-local bases, computed keys: the target
                    # is unprovable — abstain, never under-approximate
                    self.writes_unknown = True
            elif op in ("MAP_ADD", "DICT_UPDATE", "DICT_MERGE"):
                self.writes_unknown = True
            elif op == "BUILD_MAP" and (instr.arg or 0) > 0:
                self.writes_unknown = True

        # nested code objects: comprehensions, lambdas, nested defs — table
        # params arrive there as LOAD_DEREF cells under the same names
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                self.walk_code(
                    const,
                    env,
                    infer_scope=infer_scope,
                    helper=helper,
                    depth=depth,
                )

    def reset_for_repass(self) -> None:
        """Prepare for another scope pass over the same code.  Alias
        discovery is a linear scan, so ``alias = data`` reached through a
        loop back-edge is found only AFTER the instructions the alias
        governs were already scanned — re-scanning with the enlarged
        table set picks those reads up.  Reads/writes accumulate
        monotonically and findings dedup via ``_seen_findings``, so only
        the traversal bookkeeping is cleared."""
        self._seen_codes.clear()
        self._seen_helper_codes.clear()
        self._helpers.clear()
        self._codes_walked = 0

    def drain_helpers(self) -> None:
        """Contract-check transitively referenced user helpers.  Scope is
        NOT inferred inside helpers — a table passed into a helper already
        forced ``reads`` to UNKNOWN at the call site."""
        while self._helpers:
            fn, depth = self._helpers.pop(0)
            env = dict(fn.__globals__)
            code = fn.__code__
            for name, cell in zip(code.co_freevars, fn.__closure__ or ()):
                try:
                    env[name] = cell.cell_contents
                except ValueError:
                    pass
            self.walk_code(
                code,
                env,
                infer_scope=False,
                helper=fn.__qualname__,
                depth=depth,
            )


def _run_walk(
    code: types.CodeType,
    env: Dict[str, Any],
    *,
    mode: str,
    model: Optional[str],
    table_params: Sequence[str],
) -> Analysis:
    if not _SUPPORTED_INTERPRETER:
        return Analysis()
    w = _Walker(mode=mode, model=model, table_params=table_params)
    try:
        # fixpoint on the table/alias set: a table alias created at a
        # later bytecode offset (loop back-edge) must retroactively turn
        # earlier subscripts on that name into reads, or the proven scope
        # would be smaller than the truth
        passes = 0
        while True:
            tables_before = set(w.tables)
            w.walk_code(code, env, infer_scope=True)
            w.drain_helpers()
            passes += 1
            if w.tables == tables_before or w.reads_unknown:
                break
            if passes >= _MAX_SCOPE_PASSES:
                w.reads_unknown = True
                break
            w.reset_for_repass()
    except Exception:
        # an analysis bug must never take down a pipeline: degrade to the
        # pre-analysis world (no findings, everything UNKNOWN)
        return Analysis()
    reads: Scope = UNKNOWN if w.reads_unknown else frozenset(w.reads)
    writes: Scope = UNKNOWN if w.writes_unknown else frozenset(w.writes)
    return Analysis(findings=w.findings, reads=reads, writes=writes)


# decoration in hypothesis loops re-runs factories thousands of times over
# the same code objects — memoize per code object, but ONLY when the
# verdict cannot depend on the environment (see _memo_safe)
_MEMO: Dict[Tuple[types.CodeType, str, Tuple[str, ...]], Analysis] = {}


def _memo_safe(fn: types.FunctionType) -> bool:
    """True when ``fn``'s verdict is a function of its code object alone.

    The walker consults the environment in exactly two ways: it descends
    into helper *functions* resolved from closure cells / globals, and it
    classifies resolved callables, modules, and classes (nondeterminism
    checks).  Factory instances share one code object while differing in
    precisely those bindings — caching across them reproduced both missed
    and spurious RPR002s — and a module-level helper can be monkeypatched
    between decorations.  Bypass the memo whenever such a binding exists;
    the common self-contained model body stays memoized."""
    for cell in fn.__closure__ or ():
        try:
            v = cell.cell_contents
        except ValueError:
            return False  # unset cell now; may hold anything later
        if isinstance(
            v,
            (
                types.FunctionType,
                types.BuiltinFunctionType,
                types.MethodType,
                types.ModuleType,
                type,
            ),
        ):
            return False
    g = fn.__globals__
    queue: List[types.CodeType] = [fn.__code__]
    while queue:
        c = queue.pop()
        for nm in c.co_names:
            if is_user_function(g.get(nm)):
                return False
        queue.extend(k for k in c.co_consts if isinstance(k, types.CodeType))
    return True


def analyze_model_fn(
    fn: types.FunctionType,
    *,
    incremental: str = "none",
    table_params: Sequence[str] = (),
    name: Optional[str] = None,
) -> Analysis:
    """Analyze a live model function: env = its globals + closure cells."""
    if not _SUPPORTED_INTERPRETER:
        return Analysis()
    key = (fn.__code__, incremental, tuple(table_params))
    memoizable = _memo_safe(fn)
    memo = _MEMO.get(key) if memoizable else None
    if memo is not None:
        return Analysis(
            findings=[
                Finding(
                    code=f.code,
                    message=f.message,
                    filename=f.filename,
                    lineno=f.lineno,
                    model=name,
                    helper=f.helper,
                )
                for f in memo.findings
            ],
            reads=memo.reads,
            writes=memo.writes,
        )
    env = dict(fn.__globals__)
    for var, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        try:
            env[var] = cell.cell_contents
        except ValueError:
            pass
    ana = _run_walk(
        fn.__code__,
        env,
        mode=incremental,
        model=name or fn.__name__,
        table_params=table_params,
    )
    if memoizable:
        _MEMO[key] = ana
    return ana


def analyze_code(
    code: types.CodeType,
    *,
    env: Optional[Dict[str, Any]] = None,
    incremental: str = "none",
    table_params: Sequence[str] = (),
    name: Optional[str] = None,
) -> Analysis:
    """Analyze a bare code object (static module scanning: the function was
    never constructed, closures are unresolvable — strictly more UNKNOWN,
    never less sound)."""
    return _run_walk(
        code,
        env or {},
        mode=incremental,
        model=name or code.co_name,
        table_params=table_params,
    )


def referenced_functions(fn: types.FunctionType) -> List[types.FunctionType]:
    """Module-level user functions ``fn`` references by name — directly,
    through any nested code object.  Deterministic order (co_names order,
    outer code first) so fingerprints are stable.  Transitivity is the
    caller's job (``code_fingerprint`` recurses with its own seen-set)."""
    out: List[types.FunctionType] = []
    seen_names: set = set()
    queue: List[types.CodeType] = [fn.__code__]
    g = fn.__globals__
    while queue:
        c = queue.pop(0)
        for nm in c.co_names:
            if nm in seen_names:
                continue
            seen_names.add(nm)
            v = g.get(nm)
            if is_user_function(v) and v.__code__ is not fn.__code__:
                out.append(v)
        queue.extend(k for k in c.co_consts if isinstance(k, types.CodeType))
    return out

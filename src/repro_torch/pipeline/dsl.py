"""The declarative pipeline DSL — paper Listing 1, faithfully.

Users write transformations as plain functions whose *default argument
values* are :class:`Model` references; the DAG is reconstructed from those
references when the project is submitted (never stated imperatively).  A
runtime decorator pins the execution environment per node — the paper uses
`@bauplan.python("3.11", pip={"pandas": "2.0"})`; in this PyTorch port the
two "languages" are **numpy** (host) and **torch** (device), and the cache
is shared transparently across them, which is exactly the paper's
cross-language claim.

Example (compare paper Listing 1)::

    @model()
    @runtime("numpy")
    def cleaned_data(
        data=Model(
            "ns.raw_data",
            columns=["c1", "c2", "c3"],
            filter="eventTime BETWEEN 2023-01-01 AND 2023-02-01",
        )
    ):
        return data.do_something()

    @model()
    @runtime("torch")
    def training_data(data=Model("cleaned_data")):
        return {k: normalize(v) for k, v in data.items()}
"""

from __future__ import annotations

import hashlib
import inspect
import types
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence

from repro_torch.analysis import (
    SCOPE_MISMATCH,
    UNDECLARED_READ,
    UNKNOWN,
    Analysis,
    ContractError,
    analyze_model_fn,
    is_user_function,
    referenced_functions,
)

__all__ = [
    "Model",
    "ModelDef",
    "Project",
    "model",
    "runtime",
    "current_project",
    "code_fingerprint",
    "ContractError",
    "INCREMENTAL_MODES",
]

# Per-model incrementality contract (the differential-caching analogue of the
# paper's runtime decorator):
#
# - ``"none"``     — the default: the function is an arbitrary transformation
#                    (joins, aggregates, window functions); its output can only
#                    be reproduced by a full recompute, so every run re-executes
#                    it on its full input.
# - ``"rowwise"``  — the function is a pure per-row/per-key map: each output
#                    row is a function of one input row alone; rows may be
#                    *dropped* (per-row filters) but never created or
#                    reordered, and the output's sort-key window equals its
#                    input window.  Declaring it lets the executor cache the
#                    node's output differentially and run the function only on
#                    residual windows (see ``repro_torch.pipeline.executor``).
#                    A rowwise function that drops rows must return the sort
#                    key column itself (the executor cannot position-align it).
#                    With ≥2 inputs the contract is *multi-input rowwise* (an
#                    incremental sort-merge join): all inputs share one sort
#                    key, the node's window is the intersection of its inputs'
#                    windows, and each output row is a function of the input
#                    rows at one key alone — the executor feeds the function
#                    zip-aligned residual slices of every input.  Multi-input
#                    functions must always return the sort-key column
#                    (position alignment is impossible across inputs of
#                    different lengths), and output keys must be drawn from
#                    the input keys.
# - ``"keyed"``    — the function is a per-key-group aggregation over its
#                    single input: each output row is a function of ALL input
#                    rows sharing one sort-key value (sum/mean/count per key).
#                    The executor caches output at key-group granularity, so
#                    an append/overwrite re-aggregates only the touched key
#                    groups and UNION-merges them with cached groups.  Keyed
#                    functions must return the sort-key column, at most one
#                    output row region per input region (never more rows out
#                    than in), and only keys present in the input.
INCREMENTAL_MODES = ("none", "rowwise", "keyed")


@dataclass(frozen=True)
class Model:
    """A *logical* dataframe reference: name + projections + filter.

    ``name`` either matches another model in the project (an edge in the
    DAG) or a catalog table ``namespace.table`` (a scan leaf).  ``columns``
    and ``filter`` only make sense on scan leaves — the physical plan turns
    them into the system scan's projections and window.
    """

    name: str
    columns: Optional[Sequence[str]] = None
    filter: Optional[str] = None
    snapshot_id: Optional[str] = None  # time travel ("last Friday's rows")

    def __post_init__(self) -> None:
        if self.columns is not None:
            object.__setattr__(self, "columns", tuple(self.columns))


@dataclass
class ModelDef:
    name: str
    fn: Callable
    inputs: Dict[str, Model]  # arg name -> reference
    runtime: str = "numpy"  # "numpy" | "torch"
    materialize: bool = False  # publish output back to the catalog as a table
    runtime_opts: Dict[str, Any] = field(default_factory=dict)
    incremental: str = "none"  # see INCREMENTAL_MODES
    # static contracts (repro_torch.analysis): optional declared column scopes,
    # the decoration-time analysis verdict, and the verification opt-out
    reads: Optional[Sequence[str]] = None
    writes: Optional[Sequence[str]] = None
    verify: bool = True
    analysis: Optional[Analysis] = None

    @property
    def read_scope(self) -> Optional[FrozenSet[str]]:
        """The node's column read-scope: the ``reads=`` declaration when
        given, else the PROVEN inferred read set, else ``None`` (UNKNOWN —
        consumers fall back to pre-analysis behavior).  Signature
        narrowing and plan-time enforcement both key off this."""
        if self.reads is not None:
            return frozenset(self.reads)
        if self.analysis is not None and self.analysis.reads is not UNKNOWN:
            return self.analysis.reads
        return None


class Project:
    """A collection of model definitions (one user "code submission")."""

    def __init__(self, name: str = "project"):
        self.name = name
        self.models: Dict[str, ModelDef] = {}

    def add(self, mdef: ModelDef) -> None:
        if mdef.name in self.models:
            raise ValueError(f"duplicate model {mdef.name!r}")
        self.models[mdef.name] = mdef

    def __contains__(self, name: str) -> bool:
        return name in self.models

    def __getitem__(self, name: str) -> ModelDef:
        return self.models[name]


# A module-level default project makes the decorator syntax match the paper;
# tests construct explicit Projects to stay hermetic.
_DEFAULT_PROJECT = Project("default")


def current_project() -> Project:
    return _DEFAULT_PROJECT


def _extract_inputs(fn: Callable) -> Dict[str, Model]:
    sig = inspect.signature(fn)
    inputs: Dict[str, Model] = {}
    for pname, param in sig.parameters.items():
        if isinstance(param.default, Model):
            inputs[pname] = param.default
        elif param.default is inspect.Parameter.empty:
            raise TypeError(
                f"{fn.__name__}: parameter {pname!r} must default to a "
                f"bauplan-style Model(...) reference"
            )
    return inputs


def model(
    name: Optional[str] = None,
    materialize: bool = False,
    project: Optional[Project] = None,
    incremental: str = "none",
    reads: Optional[Sequence[str]] = None,
    writes: Optional[Sequence[str]] = None,
    verify: bool = True,
) -> Callable[[Callable], Callable]:
    """``@model()`` — register a transformation; DAG edges come from the
    function's ``Model`` defaults (paper: "The DAG structure is implicitly
    expressed through function inputs").

    ``incremental="rowwise"`` declares the per-row purity contract (see
    :data:`INCREMENTAL_MODES`), letting the executor re-run the function only
    on windows whose upstream rows actually changed.  A rowwise model's
    output always carries its sort-key column (the executor attaches it,
    position-aligned, when the function does not return it).  A rowwise
    model over ≥2 inputs is an incremental sort-merge join; ``"keyed"``
    declares a per-key-group aggregation cached at key granularity.

    ``reads=``/``writes=`` optionally declare the function's column scope.
    Declarations are checked against bytecode inference at decoration time
    (a proven read outside ``reads=`` raises :class:`ContractError`,
    RPR005) and feed signature narrowing + plan-time scope enforcement.
    ``verify=False`` opts a model out of static contract verification —
    for functions that are deliberately impure (fault-injection fixtures)
    while keeping their incremental declaration."""
    if incremental not in INCREMENTAL_MODES:
        # raised while only the declaration exists (no function yet), so
        # there is no model name / source location to carry
        raise ContractError(
            f"incremental must be one of {INCREMENTAL_MODES}, got {incremental!r}"
        )

    def deco(fn: Callable) -> Callable:
        rt = getattr(fn, "__repro_runtime__", "numpy")
        opts = getattr(fn, "__repro_runtime_opts__", {})
        mdef = ModelDef(
            name=name or fn.__name__,
            fn=fn,
            inputs=_extract_inputs(fn),
            runtime=rt,
            materialize=materialize,
            runtime_opts=opts,
            incremental=incremental,
            reads=tuple(reads) if reads is not None else None,
            writes=tuple(writes) if writes is not None else None,
            verify=verify,
        )
        mdef.analysis = analyze_model_fn(
            fn,
            incremental=incremental,
            table_params=tuple(mdef.inputs),
            name=mdef.name,
        )
        if verify:
            _check_declared_scopes(mdef)
        (project or _DEFAULT_PROJECT).add(mdef)
        fn.__repro_model__ = mdef
        return fn

    return deco


def _check_declared_scopes(mdef: ModelDef) -> None:
    """Declared ``reads=``/``writes=`` vs the walker's PROVEN inference —
    a mismatch is a decoration-time :class:`ContractError`.  When inference
    is UNKNOWN the declaration stands on the user's authority (the same
    trust ``incremental=`` itself gets) and nothing can be checked."""
    ana = mdef.analysis
    if ana is None:
        return
    code = mdef.fn.__code__
    if mdef.reads is not None and ana.reads is not UNKNOWN:
        undeclared = sorted(set(ana.reads) - set(mdef.reads))
        if undeclared:
            raise ContractError(
                f"[{UNDECLARED_READ}] function provably reads column(s) "
                f"{undeclared} outside its reads={sorted(mdef.reads)} "
                f"declaration",
                model=mdef.name,
                filename=code.co_filename,
                lineno=code.co_firstlineno,
            )
    if mdef.writes is not None and ana.writes is not UNKNOWN:
        unexpected = sorted(set(ana.writes) - set(mdef.writes))
        if unexpected:
            raise ContractError(
                f"[{SCOPE_MISMATCH}] function provably writes column(s) "
                f"{unexpected} outside its writes={sorted(mdef.writes)} "
                f"declaration",
                model=mdef.name,
                filename=code.co_filename,
                lineno=code.co_firstlineno,
            )


def code_fingerprint(fn: Callable) -> str:
    """Best-effort content hash of a model function's *behaviour*: bytecode
    (recursing into nested code objects), referenced names, constants,
    closure cell values, and defaults.  Two functions with the same
    fingerprint compute the same mapping; an edited body, changed constant,
    or different closed-over value changes the fingerprint — which is what
    invalidates the node (and, through signature chaining, everything
    downstream) in the differential model store.

    Module-level *helper functions* the body calls (resolved by name
    through ``__globals__``, transitively, user code only — never the
    stdlib or installed packages) are folded in too: editing a helper a
    model calls must invalidate the model's cached windows exactly like
    editing the model itself.

    Captured-by-reference state the hash cannot see (e.g. a mutated global
    read inside the body) is out of contract, exactly like the paper's
    assumption that a model is a pure function of its declared inputs."""
    h = hashlib.sha256()
    seen_codes: set = set()

    def feed_value(v: object) -> None:
        # repr() is LOSSY for arrays (numpy elides interior values with
        # '...'), so two different closed-over weight vectors could
        # fingerprint-equal and silently serve stale cached outputs — hash
        # array contents by bytes, and recurse into containers so arrays
        # nested in tuples/dicts get the same treatment
        import numpy as np

        if isinstance(v, np.ndarray):
            h.update(b"<ndarray>")
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, (tuple, list)):
            h.update(b"<seq>")
            for item in v:
                feed_value(item)
        elif isinstance(v, dict):
            h.update(b"<map>")
            for k in sorted(v, key=repr):
                feed_value(k)
                feed_value(v[k])
        elif isinstance(v, types.FunctionType):
            # a closed-over or default-valued function is behaviour, not
            # identity: hash its code (and ITS helpers), never its repr,
            # which carries a memory address and would never fingerprint-
            # equal across processes
            if is_user_function(v):
                h.update(b"<function>")
                feed_function(v)
            else:
                # library functions are pinned by qualified name only —
                # their implementation is not part of the user's code
                h.update(f"<libfn {v.__module__}.{v.__qualname__}>".encode())
        else:
            h.update(repr(v).encode())

    def feed(code: types.CodeType) -> None:
        h.update(code.co_code)
        h.update(",".join(code.co_names).encode())
        h.update(",".join(code.co_varnames).encode())
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                feed(const)
            else:
                h.update(repr(const).encode())

    def feed_function(f: Callable) -> None:
        # transitive, cycle-safe: helpers referenced by name from the
        # function's globals (user code only) enter the hash in the stable
        # co_names order the walker reports them in
        if f.__code__ in seen_codes:
            return
        seen_codes.add(f.__code__)
        feed(f.__code__)
        for cell in f.__closure__ or ():
            try:
                feed_value(cell.cell_contents)
            except ValueError:  # unfilled cell
                h.update(b"<empty-cell>")
        for helper in referenced_functions(f):
            h.update(helper.__name__.encode())
            feed_function(helper)

    seen_codes.add(fn.__code__)
    feed(fn.__code__)
    for helper in referenced_functions(fn):
        h.update(helper.__name__.encode())
        feed_function(helper)
    for cell in fn.__closure__ or ():
        try:
            feed_value(cell.cell_contents)
        except ValueError:  # unfilled cell
            h.update(b"<empty-cell>")
    for d in fn.__defaults__ or ():
        # Model references are the node's *structural* inputs — the physical
        # plan hashes them separately (minus the sort-key window, which is
        # the differential dimension).  Folding their repr in here would turn
        # every window edit into a code edit and defeat residual planning.
        if isinstance(d, Model):
            h.update(b"<model-ref>")
        else:
            feed_value(d)
    # keyword-only defaults live in __kwdefaults__, not __defaults__ — an
    # edited `*, gain=2.0` must invalidate like any other constant edit
    for k in sorted(fn.__kwdefaults__ or {}):
        h.update(k.encode())
        d = fn.__kwdefaults__[k]
        if isinstance(d, Model):
            h.update(b"<model-ref>")
        else:
            feed_value(d)
    return h.hexdigest()


def runtime(kind: str = "numpy", **opts: Any) -> Callable[[Callable], Callable]:
    """``@runtime("torch")`` — the analogue of
    ``@bauplan.python("3.11", pip={...})``: pins the node's execution
    environment without touching its logic.  A torch node runs on the
    workspace's device (the CUDA card unless the workspace says otherwise)."""
    if kind not in ("numpy", "torch"):
        raise ValueError(f"unknown runtime {kind!r}")

    def deco(fn: Callable) -> Callable:
        fn.__repro_runtime__ = kind
        fn.__repro_runtime_opts__ = dict(opts)
        return fn

    return deco

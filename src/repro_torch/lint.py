"""``python -m repro_torch.lint <module|path> ...`` — the standalone driver for
the static contract verifier (:mod:`repro_torch.analysis`).

Lints every ``@model`` function it can find under the given targets:

- **runtime models** — module-level functions carrying ``__repro_model__``
  and every model inside module-level :class:`Project` instances (full
  fidelity: globals AND closure cells resolve);
- **nested models** — ``@model(...)``-decorated functions inside factory
  functions that were never called, discovered statically from the
  factory's bytecode (closures unresolvable: strictly more conservative,
  never less sound).

Findings use the stable RPR001–RPR005 codes (see
:mod:`repro_torch.analysis.errors`); exit status is 1 when any finding is
reported, 2 when a target cannot be imported — so
``python -m repro_torch.lint src/repro examples`` is a CI gate as-is.

Usage::

    python -m repro_torch.lint src/repro examples            # text, CI gate
    python -m repro_torch.lint --format json tests/test_keyed.py
    python -m repro_torch.lint repro_torch.pipeline.dsl            # dotted module
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import types
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import (
    UNDECLARED_READ,
    UNKNOWN,
    Finding,
    analyze_code,
    analyze_model_fn,
)
from repro_torch.analysis.module_scan import iter_nested_models

__all__ = ["lint_targets", "lint_module", "lint_project", "main"]

_seq = 0


def _import_path(path: str) -> types.ModuleType:
    """Import a file path: packaged files import under their real dotted
    name (so intra-package imports resolve); loose files load standalone
    with their directory on ``sys.path`` (so sibling imports resolve)."""
    global _seq
    path = os.path.abspath(path)
    pkg_dir, parts = os.path.dirname(path), [os.path.splitext(os.path.basename(path))[0]]
    while os.path.exists(os.path.join(pkg_dir, "__init__.py")):
        pkg_dir, tail = os.path.split(pkg_dir)
        parts.insert(0, tail)
    if len(parts) > 1:
        if parts[-1] == "__init__":
            parts.pop()
        if pkg_dir not in sys.path:
            sys.path.insert(0, pkg_dir)
        return importlib.import_module(".".join(parts))
    d = os.path.dirname(path)
    if d not in sys.path:
        sys.path.insert(0, d)
    _seq += 1
    name = f"_repro_lint_target_{_seq}"
    spec = importlib.util.spec_from_file_location(name, path)
    assert spec is not None and spec.loader is not None
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _lint_mdef(mdef) -> List[Finding]:
    if not getattr(mdef, "verify", True):
        return []
    ana = getattr(mdef, "analysis", None)
    if ana is None:
        ana = analyze_model_fn(
            mdef.fn,
            incremental=mdef.incremental,
            table_params=tuple(mdef.inputs),
            name=mdef.name,
        )
    return list(ana.findings)


def lint_project(project) -> List[Finding]:
    """Findings for every model in a :class:`repro_torch.pipeline.Project`."""
    out: List[Finding] = []
    for mdef in project.models.values():
        out.extend(_lint_mdef(mdef))
    return out


def lint_module(module: types.ModuleType) -> List[Finding]:
    findings: List[Finding] = []
    seen_fns: set = set()
    for obj in vars(module).values():
        mdef = getattr(obj, "__repro_model__", None)
        if mdef is not None and id(mdef) not in seen_fns:
            seen_fns.add(id(mdef))
            findings.extend(_lint_mdef(mdef))
        models = getattr(obj, "models", None)
        if isinstance(models, dict):  # duck-typed Project
            for mdef in models.values():
                if getattr(mdef, "fn", None) is not None and id(mdef) not in seen_fns:
                    seen_fns.add(id(mdef))
                    findings.extend(_lint_mdef(mdef))
    # factory-nested models, statically
    for nested in iter_nested_models(module):
        if not nested.verify or nested.incremental == "none":
            continue
        params = tuple(
            nested.code.co_varnames[: nested.code.co_argcount]
        )
        ana = analyze_code(
            nested.code,
            env=dict(vars(module)),
            incremental=nested.incremental,
            table_params=params,
            name=nested.name,
        )
        findings.extend(ana.findings)
        if nested.reads is not None and ana.reads is not UNKNOWN:
            undeclared = sorted(set(ana.reads) - set(nested.reads))
            if undeclared:
                findings.append(
                    Finding(
                        code=UNDECLARED_READ,
                        message=(
                            f"function provably reads column(s) {undeclared} "
                            f"outside its reads={sorted(nested.reads)} "
                            f"declaration"
                        ),
                        filename=nested.code.co_filename,
                        lineno=nested.code.co_firstlineno,
                        model=nested.name,
                    )
                )
    return findings


def lint_targets(targets: Sequence[str]) -> Tuple[List[Finding], List[str]]:
    """Lint modules/paths; returns (deduped findings, import errors)."""
    findings: List[Finding] = []
    errors: List[str] = []
    for target in targets:
        files: List[str]
        if os.path.isdir(target):
            files = list(_iter_py_files(target))
        elif os.path.isfile(target):
            files = [target]
        else:
            try:
                findings.extend(lint_module(importlib.import_module(target)))
            except Exception as e:  # unimportable dotted name
                errors.append(f"{target}: {type(e).__name__}: {e}")
            continue
        for path in files:
            try:
                findings.extend(lint_module(_import_path(path)))
            except Exception as e:
                errors.append(f"{path}: {type(e).__name__}: {e}")
    deduped: List[Finding] = []
    seen: set = set()
    for f in findings:
        key = (f.filename, f.lineno, f.code, f.message)
        if key not in seen:
            seen.add(key)
            deduped.append(f)
    deduped.sort(key=lambda f: (f.filename, f.lineno, f.code))
    return deduped, errors


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="statically verify @model incrementality contracts "
        "(RPR001 cross-row op, RPR002 nondeterminism, RPR003 hidden state, "
        "RPR004 scope mismatch, RPR005 undeclared read)",
    )
    ap.add_argument("targets", nargs="+", help="module names, files, or directories")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    findings, errors = lint_targets(args.targets)
    if args.format == "json":
        print(
            json.dumps(
                [
                    {
                        "code": f.code,
                        "message": f.message,
                        "file": f.filename,
                        "line": f.lineno,
                        "model": f.model,
                        "helper": f.helper,
                    }
                    for f in findings
                ],
                indent=1,
            )
        )
    else:
        for f in findings:
            print(f.render())
        if not findings and not errors:
            print("clean: no contract findings")
    for e in errors:
        print(f"error: {e}", file=sys.stderr)
    if errors:
        return 2
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())

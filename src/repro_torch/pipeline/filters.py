"""SQL-ish filter strings → (sort-key window, post-predicate).

The paper's `Model("raw_data", filter="eventTime BETWEEN 2023-01-01 AND
2023-02-01")` is a string; this module parses the supported grammar:

    expr   := term (OR term)*
    term   := atom (AND atom)*
    atom   := col BETWEEN lit AND lit
            | col (>= | > | <= | < | = | ==) lit
            | '(' expr ')'
    lit    := integer | ISO date 'YYYY-MM-DD'

Atoms on the table's **sort key** push down to an exact
:class:`IntervalSet` window (what the differential cache reasons about);
atoms on other columns compile to an in-memory post-predicate.  ``OR`` is
supported between pure sort-key terms (set union); mixing column predicates
under ``OR`` is rejected — same restriction real pushdown planners apply.

Dates become proleptic-Gregorian ordinals (day granularity); ``BETWEEN`` is
SQL-inclusive on both ends, so ``[lo, hi]`` maps to the half-open
``[lo, hi+1)``.
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.columnar import Table
from repro_torch.core.intervals import NEG_INF, POS_INF, Interval, IntervalSet

__all__ = ["ParsedFilter", "parse_filter", "date_ordinal"]

_TOKEN = re.compile(
    r"\s*(?:(?P<lpar>\()|(?P<rpar>\))|(?P<op>>=|<=|==|=|>|<)"
    r"|(?P<date>\d{4}-\d{2}-\d{2})|(?P<int>-?\d+)"
    r"|(?P<kw>(?i:BETWEEN|AND|OR)\b)|(?P<ident>[A-Za-z_][A-Za-z_0-9.]*))"
)


def date_ordinal(s: str) -> int:
    return _dt.date.fromisoformat(s).toordinal()


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            raise ValueError(f"bad filter syntax at: {text[pos:pos+20]!r}")
        pos = m.end()
        for kind, val in m.groupdict().items():
            if val is not None:
                out.append((kind, val.upper() if kind == "kw" else val))
                break
    return out


@dataclass
class ParsedFilter:
    """window: pushdown on the sort key; predicates: post-scan row filters."""

    window: IntervalSet
    predicates: List[Tuple[str, str, int]]  # (column, op, literal)

    def predicate_fn(self) -> Optional[Callable[[Table], np.ndarray]]:
        if not self.predicates:
            return None
        preds = list(self.predicates)

        def fn(t: Table) -> np.ndarray:
            mask = np.ones(t.num_rows, dtype=bool)
            for col, op, lit in preds:
                c = t.column(col)
                if op == ">=":
                    mask &= c >= lit
                elif op == ">":
                    mask &= c > lit
                elif op == "<=":
                    mask &= c <= lit
                elif op == "<":
                    mask &= c < lit
                else:  # = / ==
                    mask &= c == lit
            return mask

        return fn

    @property
    def predicate_columns(self) -> Tuple[str, ...]:
        return tuple(sorted({c for c, _, _ in self.predicates}))

    def predicate_signature(self) -> tuple:
        """Canonical, hashable identity of the filter's *residual* semantics:
        the sorted post-predicates.  Two filter strings that denote the same
        post-predicate (whitespace, clause order, ``=`` vs ``==``) compare
        equal — this is what node signatures hash, so cosmetic filter edits
        never invalidate the differential model store.  The sort-key window
        is deliberately excluded: it is the *differential dimension* the
        executor plans incrementally (widen → residual recompute, narrow →
        full hit), not part of the node's identity."""
        return tuple(sorted(self.predicates))


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]], sort_key: str):
        self.toks = tokens
        self.i = 0
        self.sort_key = sort_key

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def pop(self, kind=None, val=None):
        k, v = self.peek()
        if kind is not None and k != kind:
            raise ValueError(f"expected {kind}, got {k}:{v}")
        if val is not None and v != val:
            raise ValueError(f"expected {val}, got {v}")
        self.i += 1
        return k, v

    def literal(self) -> int:
        k, v = self.pop()
        if k == "date":
            return date_ordinal(v)
        if k == "int":
            return int(v)
        raise ValueError(f"expected literal, got {k}:{v}")

    # expr := term (OR term)*
    def expr(self) -> ParsedFilter:
        left = self.term()
        while self.peek() == ("kw", "OR"):
            self.pop()
            right = self.term()
            if left.predicates or right.predicates:
                raise ValueError("OR over non-sort-key predicates is not pushdownable")
            left = ParsedFilter(left.window.union(right.window), [])
        return left

    # term := atom (AND atom)*
    def term(self) -> ParsedFilter:
        left = self.atom()
        while self.peek() == ("kw", "AND"):
            self.pop()
            right = self.atom()
            left = ParsedFilter(
                left.window.intersect(right.window),
                left.predicates + right.predicates,
            )
        return left

    def atom(self) -> ParsedFilter:
        k, v = self.peek()
        if k == "lpar":
            self.pop()
            inner = self.expr()
            self.pop("rpar")
            return inner
        _, col = self.pop("ident")
        k, v = self.peek()
        if (k, v) == ("kw", "BETWEEN"):
            self.pop()
            lo = self.literal()
            self.pop("kw", "AND")
            hi = self.literal()
            if col == self.sort_key:
                return ParsedFilter(IntervalSet.of((lo, hi + 1)), [])
            return ParsedFilter(
                IntervalSet.everything(), [(col, ">=", lo), (col, "<=", hi)]
            )
        k, op = self.pop("op")
        lit = self.literal()
        if col == self.sort_key:
            if op == ">=":
                w = IntervalSet.of((lit, POS_INF))
            elif op == ">":
                w = IntervalSet.of((lit + 1, POS_INF))
            elif op == "<":
                w = IntervalSet.of((NEG_INF, lit))
            elif op == "<=":
                w = IntervalSet.of((NEG_INF, lit + 1))
            else:  # equality
                w = IntervalSet.of((lit, lit + 1))
            return ParsedFilter(w, [])
        return ParsedFilter(IntervalSet.everything(), [(col, op, lit)])


def parse_filter(text: Optional[str], sort_key: str) -> ParsedFilter:
    if not text or not text.strip():
        return ParsedFilter(IntervalSet.everything(), [])
    p = _Parser(_tokenize(text), sort_key)
    out = p.expr()
    if p.i != len(p.toks):
        raise ValueError(f"trailing tokens in filter: {p.toks[p.i:]}")
    return out

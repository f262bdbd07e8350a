"""What a run hands to the metric readers and to the result line."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Check:
    """One number compared with its limit; ``ok`` when it does not pass it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    kind: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    # edit sessions: one dict per edit of the window (session, label, wall_s,
    # gets, bytes_read, bytes_from_cache, bytes_from_model_cache,
    # bytes_from_store)
    edits: List[Dict[str, Any]] = field(default_factory=list)
    # the object store's GET requests and bytes read over the window
    store_gets: int = 0
    store_bytes: int = 0
    # training: steps and tokens of the window, and each step's wait for data
    steps: int = 0
    tokens: int = 0
    data_wait_s: List[float] = field(default_factory=list)
    # UNIONs that copied in the window: launches of the kernel and the bytes
    # they must move
    union_launches: int = 0
    union_bytes: int = 0
    # the traced window's summary (``trace.DeviceTrace.summary``), or None
    trace: Optional[Dict[str, Any]] = None
    # the result's ``device`` entry, read once the window has closed and
    # before the reference runs
    device: Dict[str, Any] = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    notes: List[Tuple[str, Any]] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0

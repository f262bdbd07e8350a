"""The cards a run uses: the check that they are there, their names, power
limit and peak memory."""

from __future__ import annotations

import subprocess
import sys
from typing import Any, Dict


def require_cards(count: int) -> None:
    """Exit with code 3 and no result unless ``count`` CUDA cards are
    present: a measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card is available; nothing is measured", file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < count:
        print(f"portbench: the cell needs {count} CUDA cards, "
              f"{torch.cuda.device_count()} are present", file=sys.stderr)
        raise SystemExit(3)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unread"


def describe(count: int, device: str = "cuda") -> Dict[str, Any]:
    """The result's ``device`` entry: the peak memory of the fullest card.
    A run on the CPU (the tests' rehearsals) says so and reads no card."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count)),
        "power_limit": power_limit(),
    }

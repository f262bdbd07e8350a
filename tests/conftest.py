"""Test bootstrap: make ``python -m pytest -q`` work from the repo root.

- Prepends ``src/`` to ``sys.path`` so ``import repro`` works without the
  ``PYTHONPATH=src`` incantation (which keeps working too — duplicate path
  entries are harmless).
- Installs the deterministic hypothesis stand-in when the real package is
  not available (this container cannot pip-install).
"""

import os
import sys

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

# repo root too, so tests can drive the benchmark workloads (BENCH_3 asserts
# the incremental-engine acceptance ratios on the same loop CI smokes)
_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if _ROOT not in sys.path:
    sys.path.insert(1, _ROOT)

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_stub

    _hypothesis_stub.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (a CUDA kernel has no CPU mode); skips without one"
    )

"""Registers the ``cuda`` marker for the benchmark's tests when they are
collected on their own (``tests/conftest.py`` registers it for the whole
suite)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (a CUDA kernel has no CPU mode); skips without one"
    )

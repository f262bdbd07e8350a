"""Every configuration the registry serves fits the port's kernels: with
``use_pallas_kernels`` set, a prefill on the card launches the attention
kernel at the config's head width and the SSD kernel at its (head dim,
state) widths, and a width the kernel is not built for raises where the
reference computes.  Checked for the published configs and their reduced
ones.  The attention library is built one head width at a time.
"""

from __future__ import annotations

import pytest

from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, query_block
from repro_torch.kernels.mamba2_ssd.kernel import WIDTHS
from repro_torch.models import get_config, registry

ARCHS = registry.list_archs()


def _configs(arch):
    cfg = get_config(arch)
    return {"published": cfg, "reduced": cfg.reduced()}


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_head_width_is_built(arch):
    """phi3-mini-3.8b (hd 96) and nemotron-4-340b (hd 192) among them; the
    ``ssm`` family runs no attention."""
    for name, cfg in _configs(arch).items():
        if cfg.family == "ssm":
            continue
        assert cfg.resolved_head_dim in HEAD_DIMS, (name, cfg.resolved_head_dim)
        G = cfg.num_heads // cfg.num_kv_heads
        assert G * query_block(G) <= 64, (name, G)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_widths_are_built(arch):
    for name, cfg in _configs(arch).items():
        if cfg.family not in ("ssm", "hybrid"):
            continue
        assert (cfg.ssm_head_dim, cfg.ssm_state) in WIDTHS, (name, cfg.ssm_head_dim, cfg.ssm_state)


def test_the_registry_has_the_widths_named():
    """The widths this test exists for are in the registry."""
    widths = {get_config(a).resolved_head_dim for a in ARCHS if get_config(a).family != "ssm"}
    assert {96, 192} <= widths


def test_attention_is_built_one_library_a_head_width(monkeypatch, tmp_path):
    """Each built width is a library of its own, compiled with its width's
    define and named apart; a call of one width builds only that one, and a
    kernel built once takes no variant."""
    import subprocess

    from repro_torch.kernels import _build

    assert _build.libraries("flash_attention") == [("flash_attention", hd) for hd in HEAD_DIMS]
    assert _build.libraries("dequant") == [("dequant", None)]
    for hd in HEAD_DIMS:
        assert _build.target("flash_attention", hd).name.startswith(f"flash_attention.{hd}-")
    for bad in ((None,), (48,)):
        with pytest.raises(ValueError, match="variants"):
            _build.target("flash_attention", *bad)
    with pytest.raises(ValueError, match="variants"):
        _build.target("dequant", 64)

    started = []

    class Nvcc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            started.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return b"", b""

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Nvcc)
    assert list(_build.build("flash_attention", variant=64)) == ["flash_attention.64"]
    assert len(started) == 1 and "-DFA_HEAD_DIM=64" in started[0]
    assert (tmp_path / _build.target("flash_attention", 64).name).exists()
    assert _build.build("flash_attention", variant=64) == {"flash_attention.64": 0.0}  # built already

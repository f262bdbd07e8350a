"""``chip_smoke.py``'s model phases, rehearsed on the CPU at reduced size:
the f32 consistency phase (kernels on against off, with the MoE router
trace) and the serve phase (engine traffic, launch counts, the ring cache),
for the dense and the MoE sliding-window transformer, and the training
phase (the launcher, step parity, the checkpoint round trip, EF-int8).  On the CPU the
wrappers take their plain versions, so no kernel launches and none is
expected; on the card the same code holds the counts."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import chip_smoke
from repro_torch.models import get_config, get_model


def _reduced(arch: str, **kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


@pytest.mark.parametrize("arch,lengths", [("granite-3-2b", (40, 77)), ("mixtral-8x22b", (128,))])
def test_consistency_phase_runs_on_the_cpu(arch, lengths, capsys):
    chip_smoke.consistency_phase(_reduced(arch), lengths, greedy=True, device="cpu", new_tokens=4)
    out = capsys.readouterr().out
    assert "depth cut to 3" in out and "FAIL" not in out
    assert ("MoE layer 2" in out) == (arch == "mixtral-8x22b")


@pytest.mark.parametrize(
    "arch,lengths,max_context", [("granite-3-2b", [40, 77, 12], 128), ("mixtral-8x22b", [70, 91], 256)]
)
def test_serve_phase_runs_on_the_cpu(arch, lengths, max_context, capsys):
    cfg = _reduced(arch, use_pallas_kernels=True)
    launches = chip_smoke.serve_phase(
        cfg, slots=2, max_context=max_context, lengths=lengths, new_tokens=4, device="cpu"
    )
    assert launches == {"flash_attention": 0, "mamba2_ssd": 0}
    out = capsys.readouterr().out
    assert f"{len(lengths)} prefills" in out and "peak device memory not measured" in out
    assert ("a ring of 64 slots" in out) == (arch == "mixtral-8x22b")


def _router(logits):
    return [torch.tensor(logits, dtype=torch.float32)[None]]


def test_routing_flips_name_the_first_layer_and_its_margin():
    # one token, four experts, top-2: the 2nd and 3rd expert nearly tie
    off = _router([[3.0, 1.0, 0.9999, -2.0]])
    assert chip_smoke._routing_flips(off, off, 2) is None
    layer, margin = chip_smoke._routing_flips(_router([[3.0, 0.9998, 0.9999, -2.0]]), off, 2)
    assert layer == 0 and margin == pytest.approx(1e-4, rel=1e-2)
    far = _router([[3.0, 1.0, 0.5, -2.0]])
    layer, margin = chip_smoke._routing_flips(far + _router([[3.0, 0.4, 0.5, -2.0]]), far + far, 2)
    assert layer == 1 and margin == pytest.approx(0.5)


def test_the_chain_is_not_blamed_when_it_keeps_rounding_inside_the_bar():
    """The reduced granite holds rounding-sized differences inside the bar,
    so a difference of its logits could not be blamed on the stack: the
    attribution refuses (every attention layer itself holds)."""
    cfg = _reduced("granite-3-2b")
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode(), chip_smoke._attention_calls(cfg) as calls:
        api.prefill(params, toks)
    assert len(calls) == cfg.num_layers
    with torch.inference_mode(), pytest.raises(AssertionError, match="keeps rounding-sized differences"):
        chip_smoke._attribute_to_the_chain(cfg, api, params, toks, calls, err=1.0)


def test_one_ulp_moves_every_value_by_one_float_step():
    t = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    moved = chip_smoke._one_ulp(t)
    step = torch.nextafter(t, torch.full_like(t, float("inf"))) - t
    assert torch.all((moved - t).abs() <= step * 1.0000001 + 1e-45) and torch.all(moved != t)


def test_training_phase_runs_on_the_cpu(tmp_path, capsys):
    """Reduced granite through the launcher, and the 2-layer cut in bf16
    with granite's remat and microbatches; the CPU stands in for the card
    in the step parity."""
    cut = _reduced("granite-3-2b", dtype="bfloat16", num_layers=2, remat="full", microbatches=2)
    args = ["--arch", "granite-3-2b", "--reduced", "--steps", "8", "--batch", "2", "--seq", "32"]
    out = chip_smoke.training_phase(str(tmp_path), args=args, cut=cut, device="cpu", batch=2, seq=32)
    assert out["median_ms"] > 0
    text = capsys.readouterr().out
    assert "epochs 2-4 read 0" in text and "profile step 8" in text
    assert "bitwise equal to the uninterrupted run" in text and "ratio 0.2" in text
    assert "kernel launches {'flash_attention': 0, 'flash_attention_bwd': 0, 'mamba2_ssd': 0}" in text


def test_distributed_phase_runs_on_the_cpu(tmp_path, capsys):
    """The distributed phase at reduced size on the CPU: the launcher's
    pipeline over two gloo ranks, both schedules on two ranks against the
    sequential stack, and reduced granite's sharded step on a (1, 1) mesh
    with the elastic restore.  (Peak memory is a card number: not
    measured here.)"""
    cut = _reduced("granite-3-2b", dtype="bfloat16", num_layers=2)
    args = ["--pipeline", "2", "--steps", "12", "--batch", "2", "--seq", "8", "--ckpt-every", "6"]
    out = chip_smoke.distributed_phase(str(tmp_path), device="cpu", pipeline_args=args,
                                       cell={"S": 2, "D": 16, "MB": 2, "SEQ": 4}, micros=(2, 6), reps=2, cut=cut)
    assert out["sharded"] == {"bitwise": True, "max_diff": 0.0, "collectives": 0}
    assert out["launch"]["last_loss"] < out["launch"]["first_loss"]
    text = capsys.readouterr().out
    assert "checkpoint step 12 restored, W (2, 2, 64, 64)" in text
    assert text.count("(bars held)") == 4 and "stash 2 slots" in text and "stash 6 slots" in text
    assert "0 collectives; checkpoint restored with shardings= onto the mesh" in text
    assert "kernel launches {'flash_attention': 0, 'flash_attention_bwd': 0, 'mamba2_ssd': 0}" in text


def test_dryrun_phase_runs_on_the_cpu(tmp_path, capsys):
    """The cost-analysis phase on the CPU: two production cells, each in a
    process of its own (granite-3-2b decode_32k ends ``ok``, long_500k
    ``SKIP``), the cost model on reduced granite's training cut (the FLOPs
    counted on real and on fake tensors equal; busy time and peak memory
    are card numbers, not measured here), and the cut's step on a (2, 2)
    mesh of a fake world of 4."""
    cut = _reduced("granite-3-2b", dtype="bfloat16", num_layers=2)
    cells = [("granite-3-2b", "decode_32k", "single"), ("granite-3-2b", "long_500k", "single")]
    out = chip_smoke.dryrun_phase(str(tmp_path), device="cpu", cells=cells, cut=cut)
    assert [r["status"] for r in out["cells"]] == ["ok", "SKIP(full-attention @ 500k context)"]
    assert out["cost"]["flops"] == out["cost"]["flops_fake"] > 0
    text = capsys.readouterr().out
    assert "forward and backward ran" in text and "not measured" in text
    assert "kernel launches {'flash_attention': 0, 'flash_attention_bwd': 0, 'mamba2_ssd': 0}" in text


def test_sharded_mesh_phase_runs_on_the_cpu(tmp_path, capsys):
    """``four_card_phase``'s (2, 2) step, rehearsed on four gloo ranks:
    reduced granite's loss within 1e-2 of the plain step's."""
    out = chip_smoke.sharded_mesh_phase(_reduced("granite-3-2b", num_layers=2), str(tmp_path), device="cpu")
    assert out["loss_diff"] <= 1e-2 and out["collectives"] > 0 and out["backend"] == "gloo"

"""The ``pretrain`` cell rehearsed on the CPU at a tiny size: a sound run is
correct, and each fault of a training cell makes ``correct`` false (a step
that returns its state unchanged, half of each batch left out with the mean
over the rest, a token altered where the pipeline produces it), as does the
float8 control in the program's place."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import corpus, manifest, weights, yardstick
from portbench.reference.granite import gaps, train_steps
from portbench.run import measure

CELL = "granite-3-2b.pretrain"


def tiny(dtype: str = "float32"):
    bench = manifest.load()
    cell = manifest.cell(bench, CELL)
    config, traffic = manifest.config(cell.config), manifest.traffic(cell.traffic)
    config.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                  intermediate_size=128, vocab_size=256, attention_multiplier=16 ** -0.5)
    config["training"]["dtype"] = dtype
    traffic.update(global_batch=4, seq_len=32, mean_doc_len=8, rows_per_fragment=256, corpus_steps=12)
    return config, traffic


def run(config, traffic, seed=21):
    return measure(CELL, seed, 0.0, False, "cpu", config, traffic)


def test_a_sound_run_is_correct():
    line, rec = run(*tiny())
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"batch_mismatches", "loss_gap", "grad_norm_gap", "change_norm_gap"}
    assert line["checks"]["batch_mismatches"]["value"] == 0
    assert rec.steps == 0 and list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.train import loop
    from repro_torch.train.state import tree_leaves

    real = loop.make_train_step

    def frozen(api, opt):
        step = real(api, opt)

        def unchanged(state, batch):
            keep = [t.clone() for t in tree_leaves(state.params) + tree_leaves(state.opt)]
            state, metrics = step(state, batch)
            for t, k in zip(tree_leaves(state.params) + tree_leaves(state.opt), keep):
                t.copy_(k)
            return state, metrics

        return unchanged

    monkeypatch.setattr(loop, "make_train_step", frozen)
    line, _ = run(*tiny())
    assert not line["correct"]
    assert line["checks"]["change_norm_gap"]["value"] > 0.5


def test_half_of_each_batch_left_out_is_not_correct(monkeypatch):
    from repro_torch.train import loop

    real = loop.make_train_step

    def halved(api, opt):
        step = real(api, opt)

        def half(state, batch):
            return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

        return half

    monkeypatch.setattr(loop, "make_train_step", halved)
    line, _ = run(*tiny())
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from repro_torch.data.pipeline import TokenBatchPipeline

    real = TokenBatchPipeline.batch_at

    def altered(self, step):
        batch = real(self, step)
        tokens = batch["tokens"].copy()
        tokens[0, 3] = (tokens[0, 3] + 1) % 256
        return {**batch, "tokens": tokens}

    monkeypatch.setattr(TokenBatchPipeline, "batch_at", altered)
    line, _ = run(*tiny())
    assert not line["correct"]
    assert line["checks"]["batch_mismatches"]["value"] >= 1


def test_the_float8_control_fails_a_limit():
    config, traffic = tiny("bfloat16")
    data = corpus.tokens(5, 4 * traffic["global_batch"] * (traffic["seq_len"] + 1), config["vocab_size"],
                         traffic["mean_doc_len"], traffic["eos_id"])
    batches = [corpus.batch(data, i, traffic["global_batch"], traffic["seq_len"]) for i in range(3)]
    names = [n for n, _s, _f in weights.leaves(config)]
    initial = lambda n: weights.draw(config, 5, n, "cpu", torch.bfloat16)
    opt = config["training"]["optimizer"]
    want = train_steps(config, opt, initial, names, batches, "cpu")
    got = train_steps(config, opt, initial, names, batches, "cpu", precision="fp8")
    limits = config["training"]["check_limits"]
    read = gaps(got, want)
    assert any(read[k] > limits[k] for k in limits), read


def test_the_corpus_outlasts_the_window_at_the_roofline():
    bench = manifest.load()
    config, traffic = manifest.config("granite-3-2b"), manifest.traffic("pretrain")
    from portbench.harness.pretrain import corpus_steps

    seconds = bench["run_seconds"]
    bound = traffic["global_batch"] * traffic["seq_len"] * yardstick.train_flops_per_token(
        config, traffic["seq_len"]) / yardstick.BF16_FLOP_PER_S
    assert corpus_steps(config, traffic, seconds) * bound > seconds + traffic["checked_steps"] * bound


@pytest.mark.parametrize("leaf", ["embed", "layers.wq", "layers.ln1"])
def test_a_leaf_is_drawn_again_exactly(leaf):
    config, _ = tiny("bfloat16")
    tree = weights.make(config, 77, "cpu", torch.bfloat16)
    again = weights.draw(config, 77, leaf, "cpu", torch.bfloat16)
    node = tree
    for part in leaf.split("."):
        node = node[part]
    assert torch.equal(node, again)


def test_the_flop_count_of_granite():
    config = manifest.config("granite-3-2b")
    assert yardstick.dense_params(config) == 2_533_531_648
    assert yardstick.train_flops_per_token(config, 4096) == 6 * 2_533_531_648 + 12 * 40 * 32 * 64 * 4096

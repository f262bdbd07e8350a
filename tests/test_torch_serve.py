"""The port's ``ServeEngine`` on the CPU against the reference's engine:
the same greedy tokens for reduced zamba2-1.2b, mamba2-780m, granite-3-2b
(dense) and mixtral-8x22b (MoE, ring KV cache of the window), with mixed
prompt lengths decoding in one batch, more requests than slots (slot
reuse) and EOS; temperature sampling stays in the vocab and repeats under
one seed (its bits differ from ``jax.random``'s, so only greedy is held
token for token).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.models.registry import get_model as ref_get_model
from repro.serve import GenerateRequest as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.models import get_model
from repro_torch.serve import GenerateRequest, ServeEngine
from torch_parity import reduced_pair

ARCHS = ["zamba2-1.2b", "mamba2-780m", "granite-3-2b", "mixtral-8x22b"]
PROMPT_LENS = [12, 5, 17, 9, 3]  # five requests on two slots
NEW_TOKENS = 5


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The reduced arch on both sides and the reference engine's greedy
    tokens for five mixed-length prompts decoded on two slots."""
    rcfg, rparams, cfg, params = reduced_pair(request.param)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
    eng = RefEngine(ref_get_model(rcfg), rparams, slots=2, max_context=64)
    rids = [eng.submit(RefRequest(prompt=p, max_new_tokens=NEW_TOKENS)) for p in prompts]
    res = eng.run_until_drained()
    want = [res[r].tokens.tolist() for r in rids]
    return get_model(cfg), params, prompts, want


def _run(api, params, requests, max_context=64, **kw):
    eng = ServeEngine(api, params, max_context=max_context, device="cpu", **kw)
    rids = [eng.submit(r) for r in requests]
    res = eng.run_until_drained()
    assert set(res) == set(rids)
    return eng, [res[r].tokens.tolist() for r in rids]


def test_mixed_lengths_and_slot_reuse_match_reference(served):
    """Five requests on two slots: slots are reused, sequences at different
    depths decode in one batch, and each matches the reference engine."""
    api, params, prompts, want = served
    eng, got = _run(api, params, [GenerateRequest(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts], slots=2)
    assert got == want
    assert eng.prefills == len(prompts)


def test_single_request_matches_reference(served):
    """A request's tokens do not depend on its batchmates."""
    api, params, prompts, want = served
    _, got = _run(api, params, [GenerateRequest(prompt=prompts[2], max_new_tokens=NEW_TOKENS)], slots=1)
    assert got == [want[2]]


def test_without_donation_a_held_cache_is_not_written(served):
    api, params, prompts, want = served
    eng = ServeEngine(api, params, slots=2, max_context=64, donate_cache=False, device="cpu")
    held = eng.cache
    before = {k: v.clone() for k, v in held.items()}
    rids = [eng.submit(GenerateRequest(prompt=p, max_new_tokens=NEW_TOKENS)) for p in prompts[:2]]
    res = eng.run_until_drained()
    assert [res[r].tokens.tolist() for r in rids] == want[:2]
    assert all(torch.equal(held[k], before[k]) for k in held)
    assert eng.cache is not held


def test_eos_stops_generation(served):
    api, params, prompts, want = served
    eos = want[0][2]  # force a stop at the 3rd generated token
    stop = want[0].index(eos) + 1
    _, got = _run(api, params, [GenerateRequest(prompt=prompts[0], max_new_tokens=NEW_TOKENS, eos_id=eos)], slots=1)
    assert got == [want[0][:stop]]


def test_temperature_sampling_in_range_and_repeatable(served):
    api, params, prompts, _ = served
    reqs = lambda: [  # noqa: E731
        GenerateRequest(prompt=prompts[1], max_new_tokens=8, temperature=0.8, top_k=20),
        GenerateRequest(prompt=prompts[3], max_new_tokens=8),
    ]
    _, a = _run(api, params, reqs(), slots=2, rng_seed=3)
    _, b = _run(api, params, reqs(), slots=2, rng_seed=3)
    assert a == b
    vocab = api.cfg.vocab_size
    assert len(a[0]) == 8 and all(0 <= t < vocab for t in a[0])


def test_prompt_must_fit_the_context(served):
    api, params, _, _ = served
    eng = ServeEngine(api, params, slots=1, max_context=8, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(GenerateRequest(prompt=np.zeros(8, np.int32)))


def test_ring_cache_past_the_window_matches_reference():
    """mixtral-8x22b's window (64 reduced) is shorter than both prompts,
    neither a multiple of it: the engine admits ring caches of 64 slots
    with a nonzero rotation and decodes past the window, token for token
    with the reference (both on the kernel path, which takes any length)."""
    import dataclasses

    rcfg, rparams, cfg, params = reduced_pair("mixtral-8x22b")
    rcfg = dataclasses.replace(rcfg, use_pallas_kernels=True)
    cfg = dataclasses.replace(cfg, use_pallas_kernels=True)
    W = cfg.sliding_window
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (W + 6, W + 27)]
    eng = RefEngine(ref_get_model(rcfg), rparams, slots=2, max_context=2 * W)
    rids = [eng.submit(RefRequest(prompt=p, max_new_tokens=NEW_TOKENS)) for p in prompts]
    res = eng.run_until_drained()
    want = [res[r].tokens.tolist() for r in rids]
    port, got = _run(get_model(cfg), params, [GenerateRequest(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts],
                     slots=2, max_context=2 * W)
    assert port.cache["k"].shape[2] == W
    assert got == want

"""The port's logical-axis sharding (``repro_torch.dist.sharding``,
``repro_torch.launch.mesh``) against the reference, on the CPU.

- Rule resolution: every logical tuple of every arch's parameter and
  cache axes resolves to the reference's mesh axes, with and without a pod
  axis and sequence parallelism (the reference's ``pspec`` reads only axis
  names, so a one-device jax mesh stands in).
- The axis trees (``param_logical_axes``, ``cache_logical_axes``,
  ``state_logical_axes`` for AdamW and Adafactor) equal the reference's
  for every arch, built on the meta device from the reference's shapes.
- ``tests/test_sharding_regressions.py``'s four regressions on a ``fake``
  process group of world 8 over ``(data=2, model=4)``, in a subprocess, at
  the reference's bars, with the wire bytes counted by
  ``repro_torch.launch.hlo_cost.CollectiveBytes``.
- Four gloo ranks over ``(data=2, model=2)``: reduced granite's logits and
  one AdamW step under the rules against the same without, and the
  elastic restore (``restore_state(shardings=)``) bitwise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.dist.sharding import MeshRules as RefMeshRules
from repro.dist.sharding import _base_rules as ref_base_rules
from repro.launch.mesh import rules_for as ref_rules_for
from repro.models.registry import ARCH_IDS
from repro.models.registry import get_config as ref_get_config
from repro.models.registry import get_model as ref_get_model
from repro.train.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.train.optimizer import make_optimizer as ref_make_optimizer
from repro.train.state import state_logical_axes as ref_state_logical_axes
from repro_torch.checkpoint import save_state
from repro_torch.dist.ranks import spawn_ranks
from repro_torch.dist.sharding import _base_rules, map_axes
from repro_torch.launch.mesh import rules_for
from repro_torch.models import get_config, get_model
from repro_torch.train import OptimizerConfig, make_init_state, make_optimizer, state_logical_axes

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


class _Names:
    """A stand-in mesh for name resolution: dim names and sizes only."""

    def __init__(self, names, sizes):
        self.mesh_dim_names = tuple(names)
        self._sizes = sizes

    def size(self, dim):
        return self._sizes[dim]


def _meshes(pod: bool):
    names = ("pod", "data", "model") if pod else ("data", "model")
    ref = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(names)), names)
    return ref, _Names(names, [2] * len(names))


def _tuples(tree):
    out = []
    map_axes(lambda axes: out.append(axes), tree)
    return out


@pytest.mark.parametrize("pod", [False, True], ids=["pod", "no_pod"][::-1])
@pytest.mark.parametrize("seq_parallel", [True, False], ids=["sp", "no_sp"])
def test_rule_resolution_equals_the_reference(pod, seq_parallel):
    ref_mesh, mesh = _meshes(pod)
    assert _base_rules(pod) == ref_base_rules(pod)
    for arch in ARCH_IDS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        rules = rules_for(cfg, mesh, seq_parallel=seq_parallel)
        ref = ref_rules_for(rcfg, ref_mesh, seq_parallel=seq_parallel)
        assert isinstance(ref, RefMeshRules) and rules.rules == ref.rules
        api, rapi = get_model(cfg), ref_get_model(rcfg)
        logical = _tuples(api.param_logical_axes()) + _tuples(api.cache_logical_axes())
        logical += [("batch", "seq", "act_vocab"), ("batch", "seq", None), ("batch", None, "act_heads", None)]
        for axes in logical:
            for name in axes:
                assert rules.resolve(name) == ref.resolve(name), (arch, name)
            assert rules.pspec(axes) == tuple(ref.pspec(axes)), (arch, axes)


def _meta(sds):
    return torch.empty(sds.shape, dtype=getattr(torch, sds.dtype.name), device="meta")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axis_trees_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    api, rapi = get_model(cfg), ref_get_model(rcfg)
    assert api.param_logical_axes() == rapi.param_logical_axes()
    assert api.cache_logical_axes() == rapi.cache_logical_axes()
    shapes = jax.eval_shape(rapi.init_params, jax.random.PRNGKey(0))
    meta = jax.tree.map(_meta, shapes)
    for kind in ("adamw", "adafactor"):
        ref_opt = jax.eval_shape(ref_make_optimizer(RefOptimizerConfig(kind=kind))[0], shapes)
        opt = make_optimizer(OptimizerConfig(kind=kind))[0](meta)
        want = ref_state_logical_axes(rapi.param_logical_axes(), ref_opt)
        got = state_logical_axes(api.param_logical_axes(), opt)
        assert (got.params, got.opt, got.step) == (want.params, want.opt, want.step), kind


# ------------------------------------------------ the fake world-8 regressions
_FAKE = textwrap.dedent(
    """
    import dataclasses, json
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.hlo_cost import CollectiveBytes
    from repro_torch.dist.sharding import MeshRules, _base_rules, distribute_tree, shard, use_rules
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import get_config, get_model
    from repro_torch.train.state import tree_leaves, tree_map

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    out = {}

    # uneven heads keep their shard: rank 0 holds 2 of 6 heads
    rules = MeshRules(rules=_base_rules(pod=False), mesh=mesh)
    x = distribute_tree(torch.zeros(2, 6, 64, 64), (None, None, None, None), rules)
    with use_rules(rules):
        y = shard(x, ("batch", "act_heads", None, None)) * 2.0
    out["uneven"] = list(y.to_local().shape)

    # a size-1 batch stays replicated: the full row on every rank
    x = distribute_tree(torch.zeros(1, 64), (None, None), rules)
    with use_rules(rules):
        y = shard(x, ("batch", None)) + 1.0
    out["size1"] = [list(y.to_local().shape), [str(p) for p in y.placements]]

    def init(cfg):
        api = get_model(cfg)
        params = api.init_params(torch.Generator().manual_seed(0), "cpu")
        return api, params

    # MoE train step: reduced mixtral, 2 layers, f32, B 8, S 128
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(), num_layers=2, microbatches=1,
                              remat="none", dtype="float32")
    api, params = init(cfg)
    rules = rules_for(cfg, mesh)
    B, S = 8, 128
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    dp = distribute_tree(params, api.param_logical_axes(), rules)
    count = CollectiveBytes()
    with use_rules(rules), count:
        live = [p.detach().requires_grad_() for p in tree_leaves(dp)]
        it = iter(live)
        lg = api.forward(tree_map(lambda _: next(it), dp), distribute_tree(toks, ("batch", None), rules))
        torch.autograd.grad(torch.mean(lg.float() ** 2), live)
    param_bytes = sum(p.numel() * 4 for p in tree_leaves(params))
    out["moe"] = [count.bytes / (param_bytes + B * S * cfg.d_model * 4), count.by_kind]

    # decode: reduced granite, 2 layers, B 1, T 256
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_layers=2, dtype="float32")
    api, params = init(cfg)
    rules = rules_for(cfg, mesh)
    cache = api.init_decode_cache(1, 256, "cpu")
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    dp = distribute_tree(params, api.param_logical_axes(), rules)
    dc = distribute_tree(cache, api.cache_logical_axes(), rules)
    count = CollectiveBytes()
    with use_rules(rules), count, torch.no_grad():
        api.decode_step(dp, distribute_tree(torch.zeros((1, 1), dtype=torch.long), ("batch", None), rules), dc)
    out["decode"] = [count.bytes / cache_bytes, count.by_kind]
    print("RESULT " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def fake_world():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", _FAKE], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_uneven_heads_still_sharded(fake_world):
    """6 heads on a 4-way model axis: rank 0 holds ceil(6/4) = 2 heads of a
    batch shard, the reference's per-device f32[1,2,64,64]."""
    assert fake_world["uneven"] == [1, 2, 64, 64]


def test_size1_batch_not_parked_on_one_device(fake_world):
    shape, placements = fake_world["size1"]
    assert shape == [1, 64] and placements == ["R", "R"]


def test_moe_training_collectives_bounded(fake_world):
    ratio, kinds = fake_world["moe"]
    assert ratio < 60, f"MoE collective blowup: {ratio:.1f}x (params+tokens) {kinds}"


def test_decode_no_cache_owner_broadcast(fake_world):
    ratio, kinds = fake_world["decode"]
    assert ratio < 0.5, f"decode moves {ratio:.2f}x the cache over the wire {kinds}"


# ------------------------------------------------------------ gloo, 4 ranks
@pytest.fixture(scope="module")
def gloo_granite(tmp_path_factory):
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_layers=2)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64)
    batch = {"tokens": tokens, "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64),
             "loss_mask": (rng.random((4, 16)) > 0.1).astype(np.float32)}
    root = str(tmp_path_factory.mktemp("ckpt"))
    state = make_init_state(get_model(cfg), OptimizerConfig())(torch.Generator().manual_seed(3), "cpu")
    save_state(root, 1, state)
    return spawn_ranks(workers.sharded_granite, 4, str(tmp_path_factory.mktemp("ranks")),
                       args=(cfg, tokens, batch, root), device="cpu", timeout_s=300)


def test_sharded_forward_and_step_match_the_unsharded(gloo_granite):
    for r in gloo_granite:
        assert r["placements"] == ["S(0)", "S(2)"]  # logits: batch over data, vocab over model
        assert r["logits"] <= 1e-5 and r["loss"] <= 1e-5 and r["params"] <= 1e-5, r


def test_elastic_restore_places_each_shard_bitwise(gloo_granite):
    assert all(r["restore"] for r in gloo_granite)


def test_elastic_restore_onto_a_different_mesh(gloo_granite):
    """``tests/test_checkpoint.py::test_elastic_restore_different_mesh``:
    saved under a (4, 1) mesh, restored under (1, 4)."""
    assert all(r["elastic"] for r in gloo_granite)


# ------------------------------------------ torch 2.11's view rules, on 2.13
_VIEWS = textwrap.dedent(
    """
    import dataclasses, json, sys, threading
    import torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch_dist_workers import StrictViews
    from repro_torch.dist.sharding import distribute_tree, use_rules
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import get_config, get_model
    from repro_torch.train import OptimizerConfig, make_init_state, make_train_step, state_logical_axes
    from repro_torch.train.loop import _loss_sum
    from repro_torch.train.state import tree_leaves, tree_map

    world = int(sys.argv[1])
    shape = {8: (2, 4), 256: (16, 16)}[world]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    for arch in ("granite-3-2b", "mixtral-8x22b", "zamba2-1.2b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=2, dtype="float32")
        api, opt, rules = get_model(cfg), OptimizerConfig(), rules_for(cfg, mesh)
        B, S = 2 * shape[0], 64
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
        views = StrictViews()
        with use_rules(rules):
            state = make_init_state(api, opt)(torch.Generator().manual_seed(0), "cpu")
            state = distribute_tree(state, state_logical_axes(api.param_logical_axes(), state.opt), rules)
            batch = {"tokens": toks, "labels": toks, "loss_mask": torch.ones(B, S)}
            batch = distribute_tree(batch, {k: ("batch", None) for k in batch}, rules)
            params = distribute_tree(api.init_params(torch.Generator().manual_seed(0), "cpu"),
                                     api.param_logical_axes(), rules)
            cache = distribute_tree(api.init_decode_cache(B, S, "cpu"), api.cache_logical_axes(), rules)
            with views:
                make_train_step(api, opt)(state, batch)
                with torch.no_grad():
                    api.prefill(params, batch["tokens"], None, S)
                    api.decode_step(params, distribute_tree(toks[:, :1], ("batch", None), rules), cache)
        out[arch] = [views.views, views.refused]

    # the card runs a backward in autograd's worker thread, where the
    # thread-local rules are not active; a remat recomputation there must
    # place its tensors as the forward did
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_layers=2, remat="full")
    api, rules = get_model(cfg), rules_for(cfg, mesh)
    with use_rules(rules):
        live = tree_map(lambda p: p.detach().requires_grad_(),
                        distribute_tree(api.init_params(torch.Generator().manual_seed(0), "cpu"),
                                        api.param_logical_axes(), rules))
        t = distribute_tree(torch.randint(0, cfg.vocab_size, (8, 32)), ("batch", None), rules)
        loss, _ = _loss_sum(api, live, t, t, distribute_tree(torch.ones(8, 32), ("batch", None), rules), None)
    errors = []

    def backward():
        try:
            DTensor._op_dispatcher._allow_implicit_replication = True  # a worker inherits the caller's
            torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
        except Exception as e:
            errors.append(f"{type(e).__name__}: {str(e)[:300]}")

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=300)
    out["worker_backward"] = errors if not worker.is_alive() else ["still running"]
    print("RESULT " + json.dumps(out))
    """
)


@pytest.fixture(scope="module", params=[8, 256], ids=["world8", "world256"])
def strict_views(request):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", _VIEWS, str(request.param)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x22b", "zamba2-1.2b"])
def test_no_view_torch_2_11_refuses(strict_views, arch):
    """Every ``aten.view`` of a DTensor in a train step, a prefill and a
    decode step of the reduced arch keeps its sharded dims where torch
    2.11's DTensor accepts them (``torch_dist_workers.StrictViews``): no
    flattened group has a sharded dim behind its first or an unevenly
    sharded first, and no split leaves a first part the mesh does not
    divide."""
    views, refused = strict_views[arch]
    assert views > 0 and refused == [], refused


def test_remat_recomputes_under_the_forward_rules(strict_views):
    """A backward run in another thread (as autograd runs a card's) with
    ``remat="full"``: the recomputed layers are placed as in the forward
    (else ``CheckpointError``: recomputed tensors of other shapes)."""
    assert strict_views["worker_backward"] == []

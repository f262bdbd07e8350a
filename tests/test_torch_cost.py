"""The port's cost model (``repro_torch.launch.hlo_cost``) against the
reference's HLO cost model (``repro.launch.hlo_cost.analyze_hlo``), on the
CPU, on ``tests/test_hlo_cost.py``'s programs:

- one matmul: FLOPs and bytes equal;
- 8 stacked matmuls, a Python loop on the port's side against the
  reference's ``lax.scan``: the products' FLOPs equal, the reference adding
  its while loop's counter (an add and a compare a trip, and the last
  compare), which a Python loop has not;
- tanh + add: FLOPs equal (1 a element an op), bytes twice the reference's,
  which fuses the two into one pass (eager torch fuses nothing);
- collective wire bytes equal the ring formulas exactly, on a ``fake``
  process group of world 8 (a subprocess), over the world and over a
  4-way mesh dim, and a point-to-point receive as a collective-permute;
- counted on real and on fake tensors of the same shapes, a reduced train
  step gives the same FLOPs and bytes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import analyze_hlo
from repro_torch.launch.hlo_cost import CostCounter, CostModel, analyze

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_single_matmul_equals_the_reference():
    a, b = _arrays((128, 256), (256, 512))
    ref = analyze_hlo(_hlo(lambda x, w: x @ w, a, b))
    got = analyze(lambda x, w: x @ w, torch.from_numpy(a), torch.from_numpy(b))
    assert got.flops == ref.flops == 2 * 128 * 256 * 512
    assert got.bytes_accessed == ref.bytes_accessed


def test_stacked_matmuls_equal_the_reference_scan():
    N = 8
    x, ws = _arrays((256, 256), (N, 256, 256))
    ref = analyze_hlo(_hlo(lambda x, ws: jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0], x, ws))
    ref_one = analyze_hlo(_hlo(lambda x, w: x @ w, x, ws[0]))

    def loop(x, ws):
        for i in range(N):
            x = x @ ws[i]
        return x

    got = analyze(loop, torch.from_numpy(x), torch.from_numpy(ws))
    assert got.flops == N * ref_one.flops
    assert ref.flops - got.flops == 2 * N + 1  # the reference's loop counter
    assert got.flops_unweighted == got.flops


def test_elementwise_flops_equal_the_reference():
    (x,) = _arrays((1024,))
    ref = analyze_hlo(_hlo(lambda a: jnp.tanh(a) + 1.0, x))
    got = analyze(lambda a: torch.tanh(a) + 1.0, torch.from_numpy(x))
    assert got.flops == ref.flops == 2 * 1024
    assert got.bytes_accessed == 2 * ref.bytes_accessed  # two passes where XLA fuses one


def test_as_dict_has_the_reference_keys():
    keys = set(analyze_hlo(_hlo(lambda a: a + 1.0, np.ones(4, np.float32))).as_dict())
    assert set(CostModel().as_dict()) == keys
    got = analyze(lambda a: a + 1.0, torch.ones(4)).as_dict()
    assert set(got) == keys


_RING = textwrap.dedent(
    """
    import json, torch, torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.hlo_cost import CollectiveBytes
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    x = torch.ones(1024)
    out = {}
    for name, group in (("world", dist.group.WORLD), ("model", mesh.get_group("model"))):
        for kind, fn in (("all-gather", lambda: funcol.all_gather_tensor(x, 0, group)),
                         ("all-reduce", lambda: funcol.all_reduce(x, "sum", group)),
                         ("reduce-scatter", lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group)),
                         ("all-to-all", lambda: funcol.all_to_all_single(x, None, None, group))):
            with CollectiveBytes() as c:
                fn()
            out[name + "/" + kind] = [dist.get_world_size(group), c.bytes, c.by_kind[kind], c.count]
    with CollectiveBytes() as c:
        dist.recv(x, src=1)
    out["p2p/collective-permute"] = [2, c.bytes, c.by_kind["collective-permute"], c.count]
    print("RESULT " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def ring():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", _RING], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("group", ["world", "model"])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all"])
def test_collective_bytes_follow_the_ring_model(ring, group, kind):
    """A 4096-byte operand: the reference's per-device formulas on the
    result (an all-gather's is g operands, a reduce-scatter's 1/g)."""
    g, total, by_kind, count = ring[f"{group}/{kind}"]
    b = 4096.0
    want = {
        "all-gather": g * b * (g - 1) / g,
        "all-reduce": 2.0 * b * (g - 1) / g,
        "reduce-scatter": b / g * (g - 1),
        "all-to-all": b * (g - 1) / g,
    }[kind]
    assert g == (8 if group == "world" else 4)
    assert total == by_kind == want and count == 1


def test_a_receive_counts_as_a_collective_permute(ring):
    _, total, by_kind, count = ring["p2p/collective-permute"]
    assert total == by_kind == 4096.0 and count == 1


def test_real_and_fake_tensors_count_alike():
    """A reduced train step counted on real CPU tensors and on fake tensors
    of the same shapes: the same FLOPs and bytes (the card's check of the
    dry-run, ``chip_smoke.cost_model_phase``, rests on this)."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import get_config, get_model
    from repro_torch.train import OptimizerConfig, make_init_state, make_train_step

    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_layers=2, microbatches=2)
    api, opt = get_model(cfg), OptimizerConfig()
    step = make_train_step(api, opt)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)),
             "loss_mask": torch.ones(4, 32)}
    state = make_init_state(api, opt)(torch.Generator().manual_seed(0), "cpu")
    with CostCounter() as real:
        step(state, batch)
    with FakeTensorMode():
        state = make_init_state(api, opt)(torch.Generator(), "cpu")
        fake_batch = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in batch.items()}
        with CostCounter() as fake:
            step(state, fake_batch)
    assert real.result().flops == fake.result().flops > 0
    assert real.result().bytes_accessed == fake.result().bytes_accessed > 0

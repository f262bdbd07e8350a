"""Parity harness for the PyTorch port: one seeded catalog history replayed
into twin lakes, one reference (jax) and one port (torch) workspace or
pipeline service, and a run-by-run comparison of outputs (bitwise) and
ledgers (equal).

The reference's device tier runs its Pallas kernel in interpret mode; the
port's runs on the CPU, where its gathers take the kernel's plain version.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch


from benchmarks.workloads import write_events as ref_write_events
from chip_smoke import write_events as port_write_events
from repro.core.columnar import Table as RefTable
from repro.core.device import DeviceTier as RefTier
from repro.pipeline.executor import Workspace as RefWorkspace
from repro.service import PipelineService as RefService
from repro_torch.core.columnar import Table as PortTable
from repro_torch.core.device import DeviceTier as PortTier
from repro_torch.launch.hlo_cost import CollectiveBytes
from repro_torch.pipeline.executor import Workspace as PortWorkspace
from repro_torch.service import PipelineService as PortService

__all__ = [
    "CollectiveBytes",
    "ONE_STEP_OPT",
    "assert_one_step_matches",
    "LEDGER_KEYS",
    "SERVICE_KEYS",
    "TwinLakes",
    "TwinServices",
    "assert_same_bits",
    "assert_tables_bitwise",
    "ledger",
    "fan_in_d_attention",
    "reduced_pair",
    "to_numpy",
    "to_torch",
    "token_batch",
    "train_states",
]

# the per-run device ledger the port must reproduce exactly
LEDGER_KEYS = (
    "bytes_h2d",
    "bytes_d2h",
    "device_hits",
    "gather_fast",
    "gather_fallbacks",
    "device_union_bytes",
    "rows_to_user_fns",
)


# the per-run store ledger of a service run (BENCH_4's columns)
SERVICE_KEYS = (
    "bytes_from_store",
    "rows_to_user_fns",
    "bytes_from_model_cache",
    "bytes_from_cache",
)


def assert_same_bits(a, b, what: str = "") -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bits differ"


def assert_tables_bitwise(ref, port, what: str = "") -> None:
    assert ref.column_names == port.column_names, what
    for c in ref.column_names:
        assert_same_bits(ref.column(c), port.column(c), f"{what}:{c}")


def ledger(res) -> Dict[str, int]:
    return {k: int(getattr(res, k)) for k in LEDGER_KEYS}


class TwinLakes:
    """A reference and a port workspace over two lakes with one history.

    ``device=True`` gives each its device tier (reference: interpret mode;
    port: the CPU).  ``replay`` applies one history step to both catalogs
    with the package's own ``Table``; ``run`` runs a project pair and
    asserts bitwise-equal outputs and equal ledgers."""

    def __init__(self, root: str, *, rows_per_fragment: int, device: bool = True):
        self.ref = RefWorkspace(
            os.path.join(root, "ref"),
            rows_per_fragment=rows_per_fragment,
            device=RefTier(interpret=True) if device else None,
        )
        self.port = PortWorkspace(
            os.path.join(root, "port"),
            rows_per_fragment=rows_per_fragment,
            device=PortTier(device="cpu") if device else None,
            torch_device="cpu",
        )

    def replay(self, step: Callable) -> None:
        """``step(catalog, table_cls)`` on both lakes."""
        step(self.ref.catalog, RefTable)
        step(self.port.catalog, PortTable)

    def write_events(self, rows: int, seed: int = 0, lo: int = 0) -> None:
        """The events writer of each side (same seeded draws)."""
        ref_write_events(self.ref.catalog, rows, seed=seed, lo=lo)
        port_write_events(self.port.catalog, rows, seed=seed, lo=lo)

    def run(self, ref_project, port_project, what: str = "", **kw) -> Tuple:
        rres = self.ref.run(ref_project, **kw)
        pres = self.port.run(port_project, **kw)
        assert set(rres.outputs) == set(pres.outputs), what
        for name in rres.outputs:
            assert_tables_bitwise(rres.outputs[name], pres.outputs[name], f"{what}:{name}")
        assert ledger(pres) == ledger(rres), what
        return rres, pres


class TwinServices:
    """A reference and a port ``PipelineService`` over two lakes with one
    history; the port runs its torch nodes on the CPU.

    ``tiers=True`` attaches one device tier to both shared stores of each
    service before the first session (reference: interpret mode; port: the
    CPU).  ``run`` runs a project pair through one tenant's session on each
    side and asserts bitwise-equal outputs and equal store and device
    ledgers.  Use as a context manager."""

    def __init__(self, root: str, *, rows_per_fragment: int, tiers: bool = False, **kw):
        self.ref = RefService(
            os.path.join(root, "ref"), rows_per_fragment=rows_per_fragment, **kw
        )
        self.port = PortService(
            os.path.join(root, "port"), rows_per_fragment=rows_per_fragment,
            torch_device="cpu", **kw,
        )
        if tiers:
            for svc, tier in ((self.ref, RefTier(interpret=True)), (self.port, PortTier(device="cpu"))):
                svc.scan_cache.device = svc.model_store.device = tier

    def write_events(self, rows: int, seed: int = 0, lo: int = 0) -> None:
        ref_write_events(self.ref.catalog, rows, seed=seed, lo=lo)
        port_write_events(self.port.catalog, rows, seed=seed, lo=lo)

    def run(self, tenant: str, ref_project, port_project, what: str = "") -> Tuple:
        rres = self.ref.session(tenant).run(ref_project)
        pres = self.port.session(tenant).run(port_project)
        assert set(rres.outputs) == set(pres.outputs), what
        for name in rres.outputs:
            assert_tables_bitwise(rres.outputs[name], pres.outputs[name], f"{what}:{name}")
        keys = LEDGER_KEYS + SERVICE_KEYS
        assert {k: int(getattr(pres, k)) for k in keys} == {
            k: int(getattr(rres, k)) for k in keys
        }, what
        return rres, pres

    def shutdown(self) -> None:
        self.ref.shutdown()
        self.port.shutdown()

    def __enter__(self) -> "TwinServices":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ------------------------------------------------------------------ models
def to_numpy(x) -> np.ndarray:
    """A torch tensor (floats as f32) or a jax array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def reduced_pair(arch_id: str, seed: int = 0):
    """(reference config, reference params, port config, port params) of one
    reduced arch: the reference's own weights from ``PRNGKey(seed)``,
    carried over to the port on the CPU by ``params_from_reference``."""
    import jax

    from repro.models.registry import get_config as ref_get_config
    from repro.models.registry import get_model as ref_get_model
    from repro_torch.models import get_config, params_from_reference

    rcfg = ref_get_config(arch_id).reduced()
    rparams = ref_get_model(rcfg).init_params(jax.random.PRNGKey(seed))
    cfg = get_config(arch_id).reduced()
    return rcfg, rparams, cfg, params_from_reference(cfg, jax.tree.map(np.asarray, rparams), "cpu")


# ---------------------------------------------------------------- training
def fan_in_d_attention(cfg, tree):
    """The reference's numpy parameter tree with its query, key and value
    projections rescaled to a fan-in of ``d_model``.  The reference draws a
    ``(D, KV, hd)`` projection at the fan-in of KV, which is 1 in most
    reduced configs: keys reach ±40 and the softmax is so sharp that the
    reference's own jit and eager gradients differ by up to 6e-3 of a
    leaf's largest (mixtral-8x22b); at a fan-in of D they differ by 2e-6.
    Leaves the tree unchanged for an arch without them."""
    layers = tree["layers"]
    if "wq" not in layers:
        return tree
    D = cfg.d_model
    out = dict(tree, layers=dict(layers))
    for name, fan in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads), ("wv", cfg.num_kv_heads)):
        out["layers"][name] = (layers[name] * np.float32((fan / D) ** 0.5)).astype(layers[name].dtype)
    return out


def token_batch(cfg, batch: int, seq: int, seed: int) -> Dict[str, np.ndarray]:
    """A seeded training batch: tokens, shifted labels, a loss mask with
    about a tenth of the targets masked, and prefix embeddings for an arch
    with a frontend."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    out = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "loss_mask": (rng.random((batch, seq)) > 0.1).astype(np.float32),
    }
    if cfg.prefix_len:
        out["prefix_embeds"] = rng.standard_normal((batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return out


def train_states(arch_id: str, opt_kw: dict, *, microbatches: int = 1, seed: int = 0, conditioned: bool = True):
    """One reduced arch's training state in both packages, the port's
    carried over from the reference's by ``state_from_reference``;
    ``conditioned`` rescales the attention projections first
    (``fan_in_d_attention``).  Returns (ref step fn (jitted), ref state,
    port step fn, port state)."""
    import dataclasses

    import jax

    from repro.models.registry import get_config as ref_get_config
    from repro.models.registry import get_model as ref_get_model
    from repro.train.loop import make_train_step as ref_step
    from repro.train.optimizer import OptimizerConfig as RefOpt, make_optimizer as ref_optimizer
    from repro.train.state import TrainState as RefState
    from repro_torch.models import get_config, get_model, state_from_reference
    from repro_torch.train import OptimizerConfig, make_train_step

    rcfg = dataclasses.replace(ref_get_config(arch_id).reduced(), microbatches=microbatches)
    cfg = dataclasses.replace(get_config(arch_id).reduced(), microbatches=microbatches)
    rapi, api = ref_get_model(rcfg), get_model(cfg)
    params = jax.tree.map(np.asarray, rapi.init_params(jax.random.PRNGKey(seed)))
    if conditioned:
        params = fan_in_d_attention(cfg, params)
    params = jax.tree.map(jax.numpy.asarray, params)
    init_opt, _ = ref_optimizer(RefOpt(**opt_kw))
    rstate = RefState(params=params, opt=init_opt(params), step=jax.numpy.zeros((), jax.numpy.int32))
    state = state_from_reference(cfg, OptimizerConfig(**opt_kw), jax.tree.map(np.asarray, rstate), "cpu")
    return (
        jax.jit(ref_step(rapi, RefOpt(**opt_kw))), rstate,
        make_train_step(api, OptimizerConfig(**opt_kw)), state,
    )


ONE_STEP_OPT = dict(peak_lr=1e-3, grad_clip_norm=float("inf"))


def assert_one_step_matches(arch_id: str, *, microbatches: int = 1, conditioned: bool = True) -> None:
    """One train step of a reduced arch in both packages from one state and
    batch, held at 1e-4 (``ONE_FOR_ONE``, ``tests/test_torch_models.py``):
    the loss, the token count and the gradient norm, and every gradient
    through AdamW's first moment.  Clipping is off and the schedule's
    learning rate is 0 at step 0, so ``m = (1 - b1)·g`` exactly on both
    sides and the parameters do not move; ``m`` is held at the bar scaled
    by ``1 - b1``.  Without ``conditioned`` (the reference's own attention
    init) only the loss is held, at 1e-5 (``fan_in_d_attention``)."""
    import jax

    from repro_torch.models import get_config
    from repro_torch.train.state import tree_leaves

    rstep, rstate, step, state = train_states(arch_id, ONE_STEP_OPT, microbatches=microbatches,
                                              conditioned=conditioned)
    cfg = get_config(arch_id).reduced()
    batch = token_batch(cfg, 4, 2 * cfg.sliding_window if cfg.sliding_window else 40, seed=3)
    rstate, rm = rstep(rstate, jax.tree.map(jax.numpy.asarray, batch))
    state, m = step(state, batch)
    if not conditioned:
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
        return
    for k in ("loss", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    assert int(state.step) == int(rstate.step) == 1
    paths = jax.tree_util.tree_flatten_with_path(rstate.opt["m"])[0]
    got = tree_leaves(state.opt["m"])
    assert len(got) == len(paths)
    for (path, want), g in zip(paths, got):
        np.testing.assert_allclose(to_numpy(g), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    for want, g in zip(jax.tree_util.tree_leaves(rstate.params), tree_leaves(state.params)):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(want))

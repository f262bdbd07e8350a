"""The port's data pipeline: ``TokenBatchPipeline`` against the reference's
on twin lakes (one seeded corpus written into each), bitwise; the
reference's own data tests (``tests/test_data.py``) replayed on the port
— determinism, resume, prefetch order, the pinned snapshot, the paper's
claim at training scale that the second epoch reads no store bytes — and
``shard_batch`` on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.cache import DifferentialCache as RefCache
from repro.core.planner import ScanExecutor as RefScans
from repro.data import TokenBatchPipeline as RefPipeline
from repro.data import write_token_corpus as ref_write_corpus
from repro.lake.catalog import Catalog as RefCatalog
from repro.lake.s3sim import ObjectStore as RefStore
from repro_torch.core.cache import DifferentialCache
from repro_torch.core.intervals import IntervalSet
from repro_torch.core.planner import ScanExecutor
from repro_torch.data import TokenBatchPipeline, pack_documents, shard_batch, write_token_corpus
from repro_torch.data.packing import mask_from_doc_ids
from repro_torch.lake.catalog import Catalog
from repro_torch.lake.s3sim import ObjectStore
from torch_parity import assert_same_bits

V = 128


@pytest.fixture()
def env(tmp_path):
    store = ObjectStore(str(tmp_path / "s3"))
    catalog = Catalog(store, rows_per_fragment=4096)
    write_token_corpus(catalog, "data.corpus", 40_000, V, seed=7, mean_doc_len=100)
    scans = ScanExecutor(store, catalog, cache=DifferentialCache())
    return store, catalog, scans


def _pipe(scans, **kw):
    kw.setdefault("global_batch", 4)
    kw.setdefault("seq_len", 256)
    kw.setdefault("prefetch_depth", 0)
    return TokenBatchPipeline(scans, "data.corpus", **kw)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert_same_bits(a[k], b[k], k)


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("batch,seq", [(4, 256), (3, 100)])
def test_batches_equal_the_reference_bitwise(tmp_path, batch, seq):
    """Twin lakes with one seeded corpus: every step of two epochs, and a
    wrap past the end, gives the reference's batch bit for bit, and both
    sides read the same store bytes."""
    sides = []
    for store_cls, cat_cls, cache_cls, scans_cls, write, pipe_cls, name in (
        (RefStore, RefCatalog, RefCache, RefScans, ref_write_corpus, RefPipeline, "ref"),
        (ObjectStore, Catalog, DifferentialCache, ScanExecutor, write_token_corpus, TokenBatchPipeline, "port"),
    ):
        store = store_cls(str(tmp_path / name))
        catalog = cat_cls(store, rows_per_fragment=4096)
        write(catalog, "data.corpus", 30_000, V, seed=5, mean_doc_len=80)
        pipe = pipe_cls(scans_cls(store, catalog, cache=cache_cls()), "data.corpus",
                        global_batch=batch, seq_len=seq, prefetch_depth=0)
        sides.append((store, pipe))
    (rstore, rpipe), (store, pipe) = sides
    assert pipe.steps_per_epoch == rpipe.steps_per_epoch
    for step in list(range(2 * pipe.steps_per_epoch)) + [5 * pipe.steps_per_epoch + 1]:
        _same(pipe.batch_at(step), rpipe.batch_at(step))
    assert store.stats.bytes_read == rstore.stats.bytes_read


# ---------------------------------------------- the reference's data tests
def test_batch_shapes_and_labels_shift(env):
    _store, _catalog, scans = env
    b = _pipe(scans).batch_at(0)
    assert b["tokens"].shape == b["labels"].shape == b["loss_mask"].shape == (4, 256)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_deterministic_across_instances(env):
    _store, _catalog, scans = env
    _same(_pipe(scans).batch_at(3), _pipe(scans).batch_at(3))


def test_resume_matches_uninterrupted(env):
    _store, _catalog, scans = env
    it = iter(_pipe(scans))
    batches = [next(it) for _ in range(6)]
    it2 = iter(_pipe(scans, start_step=3))
    for want in batches[3:]:
        _same(next(it2), want)


def test_second_epoch_is_free(env):
    """Epoch 2 must be served entirely from the differential cache."""
    store, _catalog, scans = env
    p = _pipe(scans)
    n = p.steps_per_epoch
    for s in range(n):
        p.batch_at(s)
    before = store.stats.bytes_read
    assert before > 0
    for s in range(n, 2 * n):
        p.batch_at(s)
    assert store.stats.bytes_read == before, "epoch 2 read bytes from the store"


def test_eval_job_shares_trainer_cache(env):
    store, _catalog, scans = env
    p = _pipe(scans)
    p.batch_at(0)
    p.batch_at(1)
    before = store.stats.bytes_read
    scans.scan("data.corpus", ["token"], IntervalSet.of((100, 900)))
    assert store.stats.bytes_read == before


def test_prefetch_iter_equals_sync(env):
    _store, _catalog, scans = env
    sync = [_pipe(scans).batch_at(s) for s in range(4)]
    p = _pipe(scans, prefetch_depth=3)
    it = iter(p)
    for want in sync:
        _same(next(it), want)
    p.close()


def test_pinned_snapshot_survives_append(env):
    _store, catalog, scans = env
    p = _pipe(scans)
    want = p.batch_at(0)
    write_token_corpus(catalog, "data.corpus", 5_000, V, seed=9, start_pos=40_000)
    _same(p.batch_at(0), want)


def test_mask_blocks_cross_document_targets(env):
    _store, _catalog, scans = env
    b = _pipe(scans).batch_at(0)
    assert (b["loss_mask"] == 0).any()
    assert (b["loss_mask"] == 1).sum() > b["loss_mask"].size * 0.9


def test_pack_documents_and_mask_from_doc_ids():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 99, size=rng.integers(3, 40)).astype(np.int32) for _ in range(50)]
    toks, doc_ids, _n_pad = pack_documents(docs, seq_len=63)
    assert toks.shape[1] == 64
    got = np.sort(toks[doc_ids >= 0])
    np.testing.assert_array_equal(got, np.sort(np.concatenate(docs)))
    np.testing.assert_array_equal(mask_from_doc_ids(np.array([[1, 1, 1, 2, 2, -1]])), [[1, 1, 0, 1, 0]])


# --------------------------------------------------------------- placement
def test_shard_batch_on_the_cpu_shares_the_arrays(env):
    _store, _catalog, scans = env
    b = _pipe(scans).batch_at(0)
    t = shard_batch(b, "cpu")
    assert t["tokens"].dtype == torch.int32 and t["loss_mask"].dtype == torch.float32
    for k in b:
        np.testing.assert_array_equal(t[k].numpy(), b[k])
    assert np.shares_memory(t["tokens"].numpy(), b["tokens"])


def test_shard_batch_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_batch({"tokens": np.zeros((1, 2), np.int32)})

"""The port's one-launch UNION (``fragment_union`` and the run table behind
``device_union``) against the reference's ``device_union`` in interpret
mode: bitwise for every ``fiub`` width, 1-3 providers and 1-3 columns of
mixed dtypes in one UNION, aligned, unaligned and mismatched-residue runs,
empty runs and a single run, with equal ledgers.  The run table's chunking
and the kernel's byte arithmetic (head, aligned body, funnel-shifted body,
tail) are replayed on a numpy byte array; the kernel itself runs only on
the card (``cuda`` marker).  The reference is imported where it is used, so the
card's tests run where no ``jax`` is installed.
"""

from __future__ import annotations

import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.core.device import _pad_rows, device_union, to_device
from repro_torch.kernels.fragment_gather import fragment_union, union_ref
from repro_torch.kernels.fragment_gather.kernel import CHUNK_BYTES, chunk_table, tile_runs

CPU = torch.device("cpu")

# every fiub width the tier admits, as the reference narrows them
DTYPES = ["bool", "int8", "int16", "uint16", "int32", "float16", "float32", "float64"]

# name: (provider rows, runs as (provider, lo, hi)) — run order is output order
LAYOUTS = {
    # one run: the UNION is a device slice
    "single-run": ((200,), [(0, 8, 131)]),
    # block-aligned multi-run group: gather_fast
    "aligned": ((520,), [(0, 0, 128), (0, 256, 512)]),
    # off-alignment runs: gather_fallbacks; output offsets 127 rows in
    "unaligned": ((300,), [(0, 3, 130), (0, 159, 281)]),
    # a source offset whose residue mod 16 differs from its output offset's
    # for every width (5 and 77 rows against 0 and 35)
    "mismatched": ((190,), [(0, 5, 40), (0, 77, 150), (0, 151, 152)]),
    # empty runs among real ones, two providers
    "empty-runs": ((64, 90), [(0, 4, 4), (1, 9, 33), (1, 40, 40), (0, 17, 61), (1, 70, 71)]),
    # only empty runs: empty columns
    "all-empty": ((16,), [(0, 4, 4), (0, 9, 9)]),
    # three providers interleaved, multi-run groups in each, mixed alignment
    "three-providers": (
        (256, 129, 77),
        [(0, 0, 64), (0, 64, 101), (1, 3, 50), (2, 0, 8), (2, 13, 77), (0, 200, 256), (1, 100, 129)],
    ),
}

# the other columns of a 3-column UNION: mixed widths beside the one tested
MIXED = ["int8", "float32"]


def _host(dt: np.dtype, rows: int, rng: np.random.Generator) -> np.ndarray:
    if dt.kind == "b":
        return rng.integers(0, 2, rows).astype(dt)
    if dt.kind == "f":
        return rng.standard_normal(rows).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, rows, endpoint=True, dtype=dt)


def assert_same_bits(a, b, what: str = "") -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bits differ"


def _unions(dtype: str, layout: str, n_columns: int, seed: int = 0, reference: bool = False):
    """The port's providers and runs (and, with ``reference``, the
    reference's on the same host columns)."""
    rng = np.random.default_rng(seed)
    provider_rows, runs = LAYOUTS[layout]
    columns = {f"c{i}": np.dtype(d) for i, d in enumerate([dtype] + MIXED[: n_columns - 1])}
    hosts = [{c: _host(dt, n, rng) for c, dt in columns.items()} for n in provider_rows]
    port_prov = [{c: _pad_rows(to_device(h[c], CPU)) for c in columns} for h in hosts]
    port_runs = [(port_prov[p], lo, hi) for p, lo, hi in runs]
    if not reference:
        return list(columns), port_runs
    import jax.numpy as jnp

    from repro.core import device as ref_device

    ref_prov = [{c: ref_device._pad_rows(jnp.asarray(h[c])) for c in columns} for h in hosts]
    return list(columns), port_runs, [(ref_prov[p], lo, hi) for p, lo, hi in runs]


@pytest.mark.parametrize("n_columns", [1, 3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_device_union_bitwise_equals_reference(dtype, layout, n_columns):
    from repro.core import device as ref_device

    columns, port_runs, ref_runs = _unions(dtype, layout, n_columns, reference=True)
    ref_ledger, port_ledger = {}, {}
    want = ref_device.device_union(ref_runs, columns, interpret=True, ledger=ref_ledger)
    got = device_union(port_runs, columns, ledger=port_ledger)
    assert port_ledger == ref_ledger
    assert list(got) == columns
    for c in columns:
        assert_same_bits(np.asarray(want[c]), got[c].numpy(), f"{layout}:{c}")


def test_single_run_is_a_view_and_multi_run_allocates_once():
    """One run stays a slice of the provider; more runs copy into one fresh
    column each (no concatenation of parts)."""
    _cols, runs = _unions("float32", "single-run", 1)
    got = device_union(runs, ["c0"])["c0"]
    prov = runs[0][0]["c0"]
    assert got.untyped_storage().data_ptr() == prov.untyped_storage().data_ptr()
    _cols, runs = _unions("float32", "three-providers", 1)
    got = device_union(runs, ["c0"])["c0"]
    assert got.is_contiguous() and got.storage_offset() == 0
    assert got.untyped_storage().nbytes() == got.nbytes
    assert all(got.untyped_storage().data_ptr() != p["c0"].untyped_storage().data_ptr()
               for p, _lo, _hi in runs)


def test_union_holds_no_per_row_index():
    """A 2^22-row, two-run UNION builds nothing per row on the host: the CPU
    path's traced peak and the card path's run table stay far below one
    int32 per output row (the per-row index of earlier versions: 16 MB)."""
    rows = 1 << 22
    prov = {"x": _pad_rows(torch.arange(rows + 64, dtype=torch.float32))}
    runs = [(prov, 0, rows // 2), (prov, rows // 2 + 64, rows + 64)]
    index_bytes = rows * 4
    tracemalloc.start()
    try:
        got = device_union(runs, ["x"])["x"]
        # the table the card path would send, on the same runs' byte ranges
        src = np.array([0, (rows // 2 + 64) * 4]) + prov["x"].data_ptr()
        dst = np.array([0, rows // 2 * 4]) + (1 << 40)
        table = chunk_table(src, dst, np.array([rows // 2, rows // 2]) * 4)
        _now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < index_bytes / 64, f"traced peak {peak} B for {rows} output rows"
    assert table.shape[0] <= 2 + index_bytes // CHUNK_BYTES
    assert got.shape == (rows,)
    assert torch.equal(got[: rows // 2], prov["x"][: rows // 2])
    assert torch.equal(got[rows // 2:], prov["x"][rows // 2 + 64: rows + 64])


def test_union_ref_copies_bytes_for_every_dtype():
    rng = np.random.default_rng(3)
    for name in DTYPES + ["uint32", "uint64", "int64"]:
        host = _host(np.dtype(name), 100, rng)
        src = torch.from_numpy(host.copy())
        dst = torch.zeros(40, dtype=src.dtype)
        union_ref([(src, 7, dst, 3, 20), (src, 90, dst, 30, 10), (src, 0, dst, 0, 0)])
        want = np.zeros(40, host.dtype)
        want[3:23], want[30:40] = host[7:27], host[90:100]
        assert_same_bits(want, dst.numpy(), name)


def test_fragment_union_refuses_what_is_not_cuda():
    src = torch.empty(64, dtype=torch.float32, device="meta")
    dst = torch.empty(64, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fragment_union([(src, 0, dst, 0, 8)])


# ------------------------------------------------ the table, replayed on bytes
def _funnelshift_r(lo: int, hi: int, shift: int) -> int:
    return (((hi << 32) | lo) >> shift) & 0xFFFFFFFF


def _replay(memory: np.ndarray, table: np.ndarray, chunk: int) -> None:
    """The kernel's arithmetic on one byte array (addresses are offsets):
    byte head and tail, the aligned body copied word for word, or
    aligned 16-byte source words funnel-shifted into aligned destination
    words.  Asserts what the kernel assumes: an entry is at most a chunk,
    the destination body is aligned, and no load leaves the run's blocks."""
    words = memory.view(np.uint32)
    for src, dst, n in table.tolist():
        assert 0 < n <= chunk
        head = min((16 - dst % 16) % 16, n)
        body = (n - head) & ~15
        tail = n - head - body
        memory[dst:dst + head] = memory[src:src + head]
        at = head + body
        memory[dst + at:dst + at + tail] = memory[src + at:src + at + tail]
        if not body:
            continue
        frm, to = src + head, dst + head
        assert to % 16 == 0
        residue = frm % 16
        if residue == 0:
            memory[to:to + body] = memory[frm:frm + body]
            continue
        q, shift, base = residue >> 2, 8 * (residue & 3), frm - residue
        for w in range(body // 16):
            lo_at, hi_at = base + 16 * w, base + 16 * w + 16
            # both aligned words hold a byte of the run
            assert lo_at + 15 >= src and hi_at <= src + n - 1
            a = [int(x) for x in words[lo_at // 4: lo_at // 4 + 8]]
            out = [_funnelshift_r(a[q + j], a[q + j + 1], shift) for j in range(4)]
            words[(to + 16 * w) // 4:(to + 16 * w) // 4 + 4] = out


@pytest.mark.parametrize("seed", range(6))
def test_chunked_table_replays_to_union_ref(seed):
    """Random byte runs at every residue pair, cut at a small chunk so runs
    span many entries: replaying the table gives union_ref's bytes."""
    rng = np.random.default_rng(seed)
    chunk = 64
    size = 1 << 14
    memory = rng.integers(0, 256, 2 * size, dtype=np.uint8)
    want = memory.copy()
    src_at, dst_at, nbytes, runs = [], [], [], []
    free = size  # destinations in the upper half, disjoint, in order
    for _ in range(int(rng.integers(1, 12))):
        n = int(rng.integers(0, 400))
        s = int(rng.integers(0, size - n))
        d = free + int(rng.integers(0, 20))
        if d + n > 2 * size:
            break
        free = d + n
        src_at.append(s), dst_at.append(d), nbytes.append(n)
        runs.append((torch.from_numpy(want), s, torch.from_numpy(want), d, n))
    table = chunk_table(src_at, dst_at, nbytes, chunk=chunk)
    # the table tiles every run, in order, and starts each later entry of a
    # run on a chunk boundary of the destination
    assert int(table[:, 2].sum()) == sum(nbytes)
    assert all(int(d) % chunk == 0 or int(d) in dst_at for d in table[:, 1])
    _replay(memory, table, chunk)
    union_ref(runs)
    np.testing.assert_array_equal(memory, want)


def test_tile_runs_merge_consecutive_tiles():
    block_idx = np.array([4, 5, 6, 0, 1, 9, 9, 10, 2])
    src_tile, out_tile, tiles = tile_runs(block_idx)
    expanded = np.concatenate([np.arange(s, s + n) for s, n in zip(src_tile, tiles)])
    np.testing.assert_array_equal(expanded, block_idx)
    np.testing.assert_array_equal(out_tile, [0, 3, 5, 6, 8])


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_bitwise_equals_union_ref_on_the_card(card, dtype, layout):
    """``device_union`` on the card (one launch for a multi-run UNION)
    against the CPU's, and the same runs as bytes into an output one byte
    past its alignment (every residue pair), against ``union_ref``."""
    from repro_torch.kernels.fragment_gather import kernel

    columns, cpu_runs = _unions(dtype, layout, 3)
    provs = {}
    for p, _lo, _hi in cpu_runs:
        provs.setdefault(id(p), {c: p[c].cuda() for c in columns})
    gpu_runs = [(provs[id(p)], lo, hi) for p, lo, hi in cpu_runs]
    cpu_ledger, gpu_ledger = {}, {}
    want = device_union(cpu_runs, columns, ledger=cpu_ledger)
    before = kernel.launches
    got = device_union(gpu_runs, columns, ledger=gpu_ledger)
    torch.cuda.synchronize()
    assert kernel.launches - before == int(sum(hi > lo for _p, lo, hi in cpu_runs) > 1)
    assert gpu_ledger == cpu_ledger
    for c in columns:
        assert_same_bits(want[c].numpy(), got[c].cpu().numpy(), c)

    total = sum((hi - lo) * p[c].element_size() for p, lo, hi in cpu_runs for c in columns)
    out_cpu = torch.full((total + 1,), 7, dtype=torch.uint8)
    out_gpu = out_cpu.cuda()
    bytes_cpu, bytes_gpu, at = [], [], 1
    for p, lo, hi in cpu_runs:
        for c in columns:
            size = p[c].element_size()
            n = (hi - lo) * size
            bytes_cpu.append((p[c].view(torch.uint8), lo * size, out_cpu, at, n))
            bytes_gpu.append((provs[id(p)][c].view(torch.uint8), lo * size, out_gpu, at, n))
            at += n
    fragment_union(bytes_gpu)
    union_ref(bytes_cpu)
    torch.cuda.synchronize()
    assert torch.equal(out_gpu.cpu(), out_cpu)

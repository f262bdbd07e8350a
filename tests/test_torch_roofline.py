"""The port's roofline terms (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), on the CPU.

- ``roofline_report`` and ``scan_union_roofline`` return the same keys and
  values as the reference's under the same ``hw`` dict (the reference's
  ``HW_V5E``, passed to both), over cells where each of the three terms
  dominates, with and without the model's FLOPs and bytes.
- ``HW_H100``, the port's default, has ``HW_V5E``'s keys and the H100 SXM's
  data-sheet rates, and ``chip_smoke``'s bound constants read it.
"""

from __future__ import annotations

import pytest

from repro.launch import roofline as ref
from repro_torch.launch import roofline as port

CASES = [
    # compute-bound, with the model's numbers
    dict(flops_per_device=4.0e15, hbm_bytes_per_device=1.0e12, collective_bytes_per_device=1.0e9,
         n_chips=256, model_flops_total=6.0e17, model_min_bytes_total=2.0e13),
    # memory-bound, no model numbers
    dict(flops_per_device=1.0e12, hbm_bytes_per_device=5.0e12, collective_bytes_per_device=1.0e8,
         n_chips=256),
    # collective-bound, model FLOPs only
    dict(flops_per_device=1.0e12, hbm_bytes_per_device=1.0e9, collective_bytes_per_device=3.0e12,
         n_chips=512, model_flops_total=1.0e14),
    # nothing counted
    dict(flops_per_device=0.0, hbm_bytes_per_device=0.0, collective_bytes_per_device=0.0, n_chips=1),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_roofline_report_equals_the_reference(case):
    kw = CASES[case]
    want = ref.roofline_report(**kw, hw=ref.HW_V5E)
    got = port.roofline_report(**kw, hw=dict(ref.HW_V5E))
    assert got == want


@pytest.mark.parametrize("union, h2d, ref_h2d", [(1 << 30, 1 << 26, 1 << 30), (5e8, 0.0, 5e8), (0.0, 0.0, 0.0)])
def test_scan_union_roofline_equals_the_reference(union, h2d, ref_h2d):
    kw = dict(union_bytes=union, bytes_h2d=h2d, reference_bytes_h2d=ref_h2d)
    assert port.scan_union_roofline(**kw, hw=dict(ref.HW_V5E)) == ref.scan_union_roofline(**kw, hw=ref.HW_V5E)


def test_h100_constants():
    assert set(port.HW_H100) == set(ref.HW_V5E)
    assert port.HW_H100["peak_flops_bf16"] == 989e12
    assert port.HW_H100["hbm_bw"] == 3.35e12
    assert port.HW_H100["hbm_bytes"] == 80 * 10**9
    # the defaults are the H100's
    kw = CASES[0]
    assert port.roofline_report(**kw) == port.roofline_report(**kw, hw=port.HW_H100)
    assert port.roofline_report(**kw)["compute_s"] == kw["flops_per_device"] / 989e12


def test_chip_smoke_bounds_read_the_h100_constants():
    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S == port.HW_H100["hbm_bw"]
    assert chip_smoke.BF16_FLOP_PER_S == port.HW_H100["peak_flops_bf16"]
    ms, by = chip_smoke._bound_ms(0.5 * 989e9, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0, rel=1e-12)

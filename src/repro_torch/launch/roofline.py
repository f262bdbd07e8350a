"""Roofline terms of one device's share of a step, with the H100's rates.

The port of ``repro.launch.roofline``.  FLOPs, HBM bytes and collective
bytes are per-device numbers (``launch.hlo_cost`` counts the local ops of
one rank), so the three roofline terms are

    compute    = flops_per_device            / peak_flops_per_chip
    memory     = hbm_bytes_per_device        / hbm_bw_per_chip
    collective = collective_bytes_per_device / ici_bw_per_chip

which equal the ``total / (chips × per-chip-rate)`` forms.  The reference
also parses collective bytes and loop trip counts out of compiled HLO text
(``collective_bytes_from_hlo``, ``computation_multipliers``); a torch program
has no HLO, and ``launch.hlo_cost`` counts its collectives as they run, so
those parsers have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["HW_H100", "roofline_report", "scan_union_roofline"]

# NVIDIA H100 SXM5 80GB, per card (NVIDIA's data sheet; dense rates, at the
# full 700 W power limit)
HW_H100 = {
    "peak_flops_bf16": 989e12,  # FLOP/s, bf16 tensor cores, dense
    "hbm_bw": 3.35e12,  # B/s, HBM3
    # NVLink 4, one direction of one card: 900 GB/s both ways over 18 links.
    # A 16-way mesh axis spans two 8-card nodes, whose links between nodes
    # are InfiniBand (about 50 GB/s a card), so across nodes this rate is
    # optimistic.
    "ici_bw": 450e9,  # B/s
    "hbm_bytes": 80 * 10**9,  # the data sheet's 80 GB
    # host link: PCIe Gen5 x16, one direction.  Every H2D/D2H byte pays it;
    # a cache hit served from HBM rides the 3.35 TB/s wall instead.
    "host_bw": 64e9,  # B/s
}


def scan_union_roofline(
    *,
    union_bytes: float,
    bytes_h2d: float,
    reference_bytes_h2d: float,
    hw: Dict[str, float] = HW_H100,
) -> Dict[str, float]:
    """Modeled serving time for one warm scan+UNION, device tier vs numpy.

    The device path assembles the hit∪residual UNION in HBM (a gather reads
    every output byte once and writes it once → ``2 × union_bytes`` of HBM
    traffic) and pays the host link only for ``bytes_h2d`` (the fresh
    residual).  The numpy reference path assembles on host and pushes the
    whole consumed payload over the host link (``reference_bytes_h2d``).
    Both are ideal-bandwidth models; the achieved-vs-roofline fraction is
    what a measured run is judged against.
    """
    device_s = 2.0 * union_bytes / hw["hbm_bw"] + bytes_h2d / hw["host_bw"]
    host_s = reference_bytes_h2d / hw["host_bw"]
    report = {
        "union_bytes": union_bytes,
        "bytes_h2d": bytes_h2d,
        "reference_bytes_h2d": reference_bytes_h2d,
        "device_modeled_s": device_s,
        "host_modeled_s": host_s,
        # pure-HBM time: what the UNION would cost if every byte were
        # already resident (the memory-bandwidth roofline for serving)
        "hbm_roofline_s": 2.0 * union_bytes / hw["hbm_bw"],
    }
    if device_s > 0:
        report["modeled_speedup"] = host_s / device_s
        report["device_bw"] = union_bytes / device_s
        # fraction of the memory roofline the modeled device path achieves:
        # 1.0 when H2D is fully hidden (everything served from HBM)
        report["roofline_fraction"] = report["hbm_roofline_s"] / device_s
    return report


def roofline_report(
    *,
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
    n_chips: int,
    model_flops_total: Optional[float] = None,
    model_min_bytes_total: Optional[float] = None,
    hw: Dict[str, float] = HW_H100,
) -> Dict[str, float]:
    compute_s = flops_per_device / hw["peak_flops_bf16"]
    memory_s = hbm_bytes_per_device / hw["hbm_bw"]
    coll_s = collective_bytes_per_device / hw["ici_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    report = {
        **terms,
        "dominant": dominant,
        "bound_s": bound_s,
        "n_chips": n_chips,
        "hlo_flops_total": flops_per_device * n_chips,
    }
    if model_flops_total:
        report["model_flops_total"] = model_flops_total
        report["useful_flops_ratio"] = model_flops_total / max(report["hlo_flops_total"], 1.0)
    # The roofline fraction is measured against the wall the workload is
    # actually up against: the IDEAL time for the dominant resource over
    # the bound.  A decode step is memory-roofline work — judging it
    # against the compute peak would report ~0 regardless of quality.
    ideal_c = (model_flops_total or 0.0) / (n_chips * hw["peak_flops_bf16"])
    ideal_m = (model_min_bytes_total or 0.0) / (n_chips * hw["hbm_bw"])
    report["ideal_compute_s"] = ideal_c
    report["ideal_memory_s"] = ideal_m
    ideal_bound = max(ideal_c, ideal_m)  # whichever wall binds the IDEAL program
    if ideal_bound > 0:
        report["roofline_fraction"] = ideal_bound / max(bound_s, 1e-30)
    return report

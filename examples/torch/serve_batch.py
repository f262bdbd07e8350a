"""Batched serving example on the PyTorch port: continuous batching over
mixed requests.

Loads a reduced mixtral-family MoE model (weights drawn from a seeded
``torch.Generator``), submits a burst of requests with different prompt
lengths / sampling settings, and drains the engine on the CUDA card —
printing per-request latency and the engine's batching efficiency.

Run:  python examples/torch/serve_batch.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import get_config, get_model
from repro_torch.serve import GenerateRequest, ServeEngine

SLOTS = 4


def requests(cfg):
    """The burst: ten requests from ``default_rng(0)``; even ones greedy,
    odd ones sampled at temperature 0.8 from the top 20."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        plen = int(rng.integers(4, 40))
        reqs.append(
            GenerateRequest(
                prompt=rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32),
                max_new_tokens=int(rng.integers(8, 24)),
                temperature=0.0 if i % 2 == 0 else 0.8,
                top_k=0 if i % 2 == 0 else 20,
            )
        )
    return reqs


def serve(api, params, device):
    """Drain the burst on ``SLOTS`` slots; returns (results in request
    order, the engine, wall seconds)."""
    eng = ServeEngine(api, params, slots=SLOTS, max_context=128, device=device)
    t0 = time.perf_counter()
    rids = [eng.submit(r) for r in requests(api.cfg)]
    results = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    return [results[r] for r in rids], eng, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("mixtral-8x22b").reduced()
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), device)
    print(f"model: reduced mixtral family ({cfg.num_experts} experts, "
          f"top-{cfg.experts_per_token}), vocab {cfg.vocab_size}")

    results, eng, wall = serve(api, params, device)

    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    total_new = sum(len(res.tokens) for res in results)
    print(f"\n{len(results)} requests, {SLOTS} slots, {eng.decode_steps} decode steps, "
          f"{eng.prefills} prefills")
    print(f"generated {total_new} tokens in {wall:.2f}s "
          f"({total_new/wall:.1f} tok/s on {where})")
    print(f"batching efficiency: {total_new/max(eng.decode_steps*SLOTS,1):.0%} "
          f"of slot-steps produced a token\n")
    for res in results[:5]:
        print(f"req {res.req_id}: prompt {res.prompt_len:>2} -> "
              f"{len(res.tokens):>2} new tokens, {res.wall_s:.2f}s")
    return results, eng


if __name__ == "__main__":
    main()

"""Batched serving engine: continuous batching over a fixed slot grid.

The port of ``repro.serve.engine``.  The engine is host logic: a request
queue, per-slot generation state, and a scheduler that admits new requests
into free slots between decode steps (continuous batching).  Each admitted
prompt is prefilled on a batch-1 view, its cache right-padded to the slot's
context length and written into the engine's cache at its slot.

It serves every family the registry serves through the uniform ModelAPI:
the constant-size SSM/conv state for mamba, plus a KV cache per shared
attention block for the hybrid.

Differences from the reference: there is no ``jit`` — prefill and decode run
eagerly under ``torch.inference_mode()`` on the engine's device; sampling
runs on the host from one seeded ``torch.Generator``, so only greedy
decoding reproduces the reference's tokens.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.registry import ModelAPI
from repro_torch.serve.sampling import sample_token

__all__ = ["GenerateRequest", "GenerateResult", "ServeEngine"]

_REQ_IDS = itertools.count()


@dataclass
class GenerateRequest:
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    req_id: int = field(default_factory=lambda: next(_REQ_IDS))


@dataclass
class GenerateResult:
    req_id: int
    prompt_len: int
    tokens: np.ndarray  # (N,) generated ids
    steps: int
    wall_s: float


@dataclass
class _Slot:
    req: Optional[GenerateRequest] = None
    generated: List[int] = field(default_factory=list)
    remaining: int = 0

    @property
    def free(self) -> bool:
        return self.req is None


def _clone(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in cache.items()}


class ServeEngine:
    """Fixed-slot continuous batching around one decode step.

    ``device`` is where the cache lives and the model runs (the params must
    already be there); the default is the CUDA card, and without one the
    constructor raises unless asked for ``"cpu"``.

    With ``donate_cache`` (the default) the engine's cache is updated in
    place: each decode step writes the new states and K/V rows into it, and
    admitting a request is an index copy of its prefill cache into the
    slot's rows.  Without it, every step and every admission works on a
    copy, so a cache the caller still holds is never written.
    """

    def __init__(
        self,
        api: ModelAPI,
        params: Any,
        *,
        slots: int = 8,
        max_context: int = 1024,
        rng_seed: int = 0,
        donate_cache: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.api = api
        self.params = params
        self.slots = [_Slot() for _ in range(slots)]
        self.B = slots
        self.max_context = max_context
        self.donate_cache = donate_cache
        self.queue: Deque[GenerateRequest] = deque()
        self.results: Dict[int, GenerateResult] = {}
        self._t0: Dict[int, float] = {}
        self._steps: Dict[int, int] = {}
        self.generator = torch.Generator().manual_seed(rng_seed)

        with torch.inference_mode():
            self.cache = api.init_decode_cache(self.B, max_context, self.device)
        # decode steps run on (B, 1) tokens; keep last sampled per slot
        self._last_tokens = np.zeros((self.B, 1), np.int32)
        self.decode_steps = 0
        self.prefills = 0

    # -------------------------------------------------------------- requests
    def submit(self, req: GenerateRequest) -> int:
        if len(req.prompt) >= self.max_context:
            raise ValueError(
                f"prompt len {len(req.prompt)} >= max_context {self.max_context}"
            )
        self.queue.append(req)
        return req.req_id

    # ------------------------------------------------------------- scheduling
    def _admit(self) -> None:
        """Fill free slots from the queue, then prefill each admitted prompt
        on a batch-1 view and scatter its cache into the slot."""
        newly: List[Tuple[int, GenerateRequest]] = []
        for i, slot in enumerate(self.slots):
            if slot.free and self.queue:
                req = self.queue.popleft()
                slot.req = req
                slot.generated = []
                slot.remaining = req.max_new_tokens
                newly.append((i, req))
        for i, req in newly:
            self._t0[req.req_id] = time.perf_counter()
            self._steps[req.req_id] = 0
            toks = torch.tensor(np.asarray(req.prompt, np.int32), device=self.device)[None, :]
            with torch.inference_mode():
                logits, cache1 = self.api.prefill(self.params, toks, max_len=self.max_context)
                self.prefills += 1
                self._scatter_cache(i, cache1)
            nxt = sample_token(
                logits.float().cpu(), self.generator,
                temperature=req.temperature, top_k=req.top_k,
            )
            tok = int(nxt[0])
            slot = self.slots[i]
            slot.generated.append(tok)
            slot.remaining -= 1
            self._last_tokens[i, 0] = tok
            self._maybe_finish(i)

    def _scatter_cache(self, slot_idx: int, cache1: Dict[str, torch.Tensor]) -> None:
        """Write a batch-1 prefill cache into slot ``slot_idx``.

        Every cache leaf has a per-sequence batch dim (axis 1 for the
        layer-stacked KV/state tensors, axis 0 for pos/kv_pos), so admission
        is a row copy; no state is shared across slots."""
        cache = self.cache if self.donate_cache else _clone(self.cache)
        for name, dst in cache.items():
            src = cache1[name]
            if dst.dim() >= 2 and dst.shape[1] == self.B and src.shape[1] == 1:
                dst[:, slot_idx : slot_idx + 1].copy_(src)
            elif dst.shape[0] == self.B and src.shape[0] == 1:
                dst[slot_idx : slot_idx + 1].copy_(src)
            else:
                raise ValueError(
                    f"cache leaf {name} {tuple(dst.shape)} has no batch dim matching B={self.B}"
                )
        self.cache = cache

    def _maybe_finish(self, i: int) -> None:
        slot = self.slots[i]
        req = slot.req
        assert req is not None
        done = slot.remaining <= 0 or (
            req.eos_id is not None and slot.generated and slot.generated[-1] == req.eos_id
        )
        if done:
            self.results[req.req_id] = GenerateResult(
                req_id=req.req_id,
                prompt_len=len(req.prompt),
                tokens=np.asarray(slot.generated, np.int32),
                steps=self._steps.pop(req.req_id, 0),
                wall_s=time.perf_counter() - self._t0.pop(req.req_id, time.perf_counter()),
            )
            slot.req = None

    # ---------------------------------------------------------------- stepping
    def step(self) -> int:
        """One engine tick: admit, one batched decode step, sample, retire.
        Returns the number of active slots."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return 0
        tokens = torch.tensor(self._last_tokens, device=self.device)
        with torch.inference_mode():
            cache = self.cache if self.donate_cache else _clone(self.cache)
            logits, self.cache = self.api.decode_step(self.params, tokens, cache)
        self.decode_steps += 1
        # per-slot sampling parameters differ: greedy for temperature 0,
        # categorical otherwise, each on its own row of the host logits
        lg = logits.float().cpu()
        for i in active:
            slot = self.slots[i]
            req = slot.req
            nxt = sample_token(
                lg[i : i + 1], self.generator,
                temperature=req.temperature, top_k=req.top_k,
            )
            tok = int(nxt[0])
            slot.generated.append(tok)
            slot.remaining -= 1
            self._steps[req.req_id] = self._steps.get(req.req_id, 0) + 1
            self._last_tokens[i, 0] = tok
            self._maybe_finish(i)
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, GenerateResult]:
        steps = 0
        while (self.queue or any(not s.free for s in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.results

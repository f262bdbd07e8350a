"""Plain float32 training of a dense pre-norm transformer (granite-3-2b's
family as the port runs it) for the benchmark's check.

Written from the architecture's equations in plain ``torch`` with TF32 off:
RMSNorm, rotary positions (rotate-half), grouped-query causal attention with
softmax in float32, a SwiGLU feed-forward, tied embeddings and the token
mean of the masked next-token loss; then AdamW with global-norm clipping,
linear warm-up and cosine decay, decoupled weight decay on every leaf of
two or more dimensions as stored (the layers are stacked, so the norms'
scales decay too, as in the program's optimizer).  Each layer runs under
``torch.utils.checkpoint`` and each row of the batch on its own, so the
reference fits beside nothing else on the card.  It imports nothing of the
program.

``precision="fp8"`` is the control: the inputs of every product are rounded
to float8 (e4m3, one scale a tensor) in the forward pass, one precision
below the bfloat16 the configuration states.  ``rows`` restricts the loss to
some rows of each batch, with the mean over them: the fault of a batch half
left out.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "mlp.w1", "mlp.w2", "mlp.w3")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale, gradient passed through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x).detach()


class Granite:
    def __init__(self, model: Mapping[str, Any], precision: str = "float32"):
        self.D = model["hidden_size"]
        self.H = model["num_attention_heads"]
        self.KV = model["num_key_value_heads"]
        self.hd = self.D // self.H
        self.eps = model["rms_norm_eps"]
        self.theta = model["rope_theta"]
        self.scale = model.get("attention_multiplier", self.hd ** -0.5)
        self.precision = precision

    def mm(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = _fp8(a), _fp8(b)
        return torch.einsum(eq, a, b)

    def norm(self, x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * w

    def rope(self, x):
        S, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / self.theta ** (torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd)
        ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def layer(self, x, ln1, ln2, wq, wk, wv, wo, w1, w2, w3):
        S = x.shape[1]
        h = self.norm(x, ln1)
        q = self.rope(self.mm("bsd,dhk->bshk", h, wq))
        k = self.rope(self.mm("bsd,dhk->bshk", h, wk))
        v = self.mm("bsd,dhk->bshk", h, wv)
        k = k.repeat_interleave(self.H // self.KV, dim=2)
        v = v.repeat_interleave(self.H // self.KV, dim=2)
        s = self.mm("bshk,bthk->bhst", q, k) * self.scale
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        x = x + self.mm("bshk,hkd->bsd", self.mm("bhst,bthk->bshk", p, v), wo)
        h = self.norm(x, ln2)
        f = F.silu(self.mm("bsd,df->bsf", h, w1)) * self.mm("bsd,df->bsf", h, w3)
        return x + self.mm("bsf,fd->bsd", f, w2)

    def loss_sum(self, p: Mapping[str, torch.Tensor], tokens, labels, mask):
        """(sum of the masked next-token losses, count of counted labels)."""
        x = F.embedding(tokens.long(), p["embed"])
        per_layer = [torch.unbind(p["layers." + k]) for k in LAYER_KEYS]
        for ws in zip(*per_layer):
            x = checkpoint(self.layer, x, *ws, use_reentrant=False)
        x = self.norm(x, p["final_norm"])
        logits = self.mm("bsd,vd->bsv", x, p["embed"])
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (torch.logsumexp(logits, dim=-1) - gold) * mask
        return nll.sum(), mask.sum()


def _lr(opt: Mapping[str, Any], step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["decay_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    mult = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["peak_lr"] * warm * mult


def train_steps(model: Mapping[str, Any], opt: Mapping[str, Any], initial: Callable[[str], torch.Tensor],
                names: Sequence[str], batches: List[Mapping[str, Any]], device,
                precision: str = "float32", rows: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Steps of plain AdamW from the weights ``initial(name)`` (drawn again
    leaf by leaf, so no copy is kept) over ``batches``.  Returns each
    step's loss, every leaf's norm of the first step's gradient as the
    optimizer takes it (after clipping), and every leaf's norm of the
    change of the weights after the last step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = Granite(model, precision)
    p = {n: initial(n).to(F32).requires_grad_() for n in names}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, first_grad = [], {}
    b1, b2 = opt["b1"], opt["b2"]
    for step, batch in enumerate(batches):
        t = {k: torch.as_tensor(batch[k]).to(device) for k in ("tokens", "labels", "loss_mask")}
        use = range(t["tokens"].shape[0]) if rows is None else rows
        grads = {n: torch.zeros_like(x) for n, x in p.items()}
        nll = count = 0.0
        for r in use:
            s, c = net.loss_sum(p, t["tokens"][r:r + 1], t["labels"][r:r + 1], t["loss_mask"][r:r + 1].to(F32))
            for n, g in zip(names, torch.autograd.grad(s, [p[n] for n in names])):
                grads[n] += g
            nll, count = nll + s.detach(), count + c
        losses.append(float(nll / count))
        with torch.no_grad():
            for g in grads.values():
                g.div_(count)
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            clip = min(1.0, opt["grad_clip_norm"] / (float(norm) + 1e-9))
            lr = _lr(opt, step)
            bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for n in names:
                g = grads[n].mul_(clip)
                if step == 0:
                    first_grad[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"])
                if p[n].ndim >= 2:
                    upd += opt["weight_decay"] * p[n]
                p[n] -= lr * upd
            del grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p[n] - initial(n).to(F32))) for n in names}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}


def worst_leaf_gap(got: Mapping[str, float], want: Mapping[str, float],
                   counted: Optional[Sequence[str]] = None) -> float:
    """The worst leaf's gap between two norms, ``|got - want|``, measured
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    names = list(counted if counted is not None else want)
    ordered = sorted(want[n] for n in want)
    median = ordered[len(ordered) // 2]
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in names)


def moved_leaves(grad_norms: Mapping[str, float]) -> List[str]:
    """The leaves whose reference gradient is more than a thousandth of the
    median leaf's; the others move under Adam by round-off alone."""
    ordered = sorted(grad_norms.values())
    median = ordered[len(ordered) // 2]
    return [n for n, g in grad_norms.items() if g > 1e-3 * median]


def gaps(got: Mapping[str, Any], want: Mapping[str, Any]) -> Dict[str, float]:
    """The numbers the check compares, of a run ``got`` against the
    reference ``want`` (both as ``train_steps`` returns them): the worst
    step's loss gap, and the worst leaf's gaps of the first gradient's and
    of the change's norms (the change over the leaves the reference moves)."""
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(got["losses"], want["losses"])),
        "grad_norm_gap": worst_leaf_gap(got["grad_norms"], want["grad_norms"]),
        "change_norm_gap": worst_leaf_gap(got["change_norms"], want["change_norms"],
                                          moved_leaves(want["grad_norms"])),
    }

"""The initial weights of a dense transformer, drawn from the seed on the
device, in the layout both the program and the reference read.

Every leaf draws from a ``torch.Generator`` of its own, seeded by the run's
seed and the leaf's index, so a leaf can be drawn again alone (the
reference and the set-up's check redraw them one at a time instead of
keeping a copy).  Matrices are ``normal(0, 1) / sqrt(fan_in)`` drawn in
float32 and stored in ``dtype``; norms are ones.  The tree is the port's
(``embed``, ``layers`` stacked over layers, ``final_norm``), which is also
the published checkpoint's structure with the layers stacked.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

Leaf = Tuple[str, Tuple[int, ...], int]  # dotted path, shape, fan-in (0: ones)


def leaves(model: Mapping[str, Any]) -> List[Leaf]:
    D, F, V, L = (model[k] for k in ("hidden_size", "intermediate_size", "vocab_size",
                                      "num_hidden_layers"))
    H, KV = model["num_attention_heads"], model["num_key_value_heads"]
    hd = D // H
    return [
        ("embed", (V, D), D),
        ("final_norm", (D,), 0),
        ("layers.ln1", (L, D), 0),
        ("layers.ln2", (L, D), 0),
        ("layers.mlp.w1", (L, D, F), D),
        ("layers.mlp.w2", (L, F, D), F),
        ("layers.mlp.w3", (L, D, F), D),
        ("layers.wk", (L, D, KV, hd), D),
        ("layers.wo", (L, H, hd, D), H * hd),
        ("layers.wq", (L, D, H, hd), D),
        ("layers.wv", (L, D, KV, hd), D),
    ]


def _seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + index * 7_919 + 1) % (1 << 62)


def draw(model: Mapping[str, Any], seed: int, path: str, device, dtype):
    """One leaf, drawn again exactly as ``make`` draws it."""
    import torch

    for i, (name, shape, fan_in) in enumerate(leaves(model)):
        if name == path:
            if not fan_in:
                return torch.ones(shape, dtype=dtype, device=device)
            gen = torch.Generator(device=device).manual_seed(_seed(seed, i))
            t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            return t.mul_(fan_in ** -0.5).to(dtype)
    raise KeyError(path)


def make(model: Mapping[str, Any], seed: int, device, dtype) -> Dict[str, Any]:
    """The whole tree, one large draw a leaf."""
    tree: Dict[str, Any] = {}
    for name, _shape, _fan in leaves(model):
        *parents, last = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = draw(model, seed, name, device, dtype)
    return tree

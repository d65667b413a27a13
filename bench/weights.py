"""One node's float32 parameters of a configuration, made from the seed on
the device in one draw.

The tree holds the embedding, the final norm's gain and the LM head, and the
block leaves of the configuration's family (``bench/families/<family>.py``
``layout``), each stacked over a leading layer axis.  One ``torch.randn``
on a generator seeded with ``seed`` fills every random leaf in the layout's
order, each then scaled: projections by ``1/sqrt(fan_in)``, the embedding
and the LM head by 0.02, others as the family says.  The rest is set: norm
gains 1, biases 0, and what the family's own inits make.
"""
from __future__ import annotations

import math

import torch

from bench import families


def _vocab_padded(cfg: dict) -> int:
    return -(-cfg["vocab"] // 256) * 256


def layout(cfg: dict) -> dict:
    """``{path: (shape, init)}``; ``init`` is a scale for a random leaf,
    ``"ones"``, ``"zeros"``, or a function ``(shape, device)`` of the
    family's."""
    d, layers = cfg["d_model"], cfg["n_layers"]

    def proj(d_in, d_out, lead=(layers,)):
        return (*lead, d_in, d_out), 1.0 / math.sqrt(d_in)

    return {"embed": ((_vocab_padded(cfg), d), 0.02),
            "final_ln": ((d,), "ones"),
            "lm_head": ((d, _vocab_padded(cfg)), 0.02),
            **families.of(cfg).layout(cfg, proj)}


def make(cfg: dict, seed: int, device) -> dict:
    """The nested parameter tree of one node."""
    lay = layout(cfg)
    random = [(p, shape, init) for p, (shape, init) in lay.items() if isinstance(init, float)]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in random), generator=gen,
                       dtype=torch.float32, device=device)
    leaves, at = {}, 0
    for path, shape, scale in random:
        n = math.prod(shape)
        leaves[path] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    for path, (shape, init) in lay.items():
        if isinstance(init, float):
            continue
        if callable(init):
            leaves[path] = init(shape, device)
        else:
            fill = {"ones": torch.ones, "zeros": torch.zeros}[init]
            leaves[path] = fill(shape, dtype=torch.float32, device=device)
    tree: dict = {}
    for path, leaf in leaves.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree

"""One node's float32 parameters of a configuration, made from the seed on
the device in one draw.

The tree and its keys are the configuration's family's (see
:mod:`bench.reference.model`), every block leaf stacked over a leading
layer axis.  One ``torch.randn`` on a generator seeded with ``seed`` fills
every random leaf, each then scaled: projections by ``1/sqrt(fan_in)``, the
embedding and the LM head by 0.02, the conv by 0.1.  The rest is set:
norm gains 1, the conv bias 0, ``A_log = log(linspace(1, 16, H))``, ``D =
1`` and ``dt_bias = log(expm1(0.01))``, the usual Mamba2 start.
"""
from __future__ import annotations

import math

import torch


def _vocab_padded(cfg: dict) -> int:
    return -(-cfg["vocab"] // 256) * 256


def layout(cfg: dict) -> dict:
    """``{path: (shape, init)}``; ``init`` is a scale for a random leaf or
    a name for a set one."""
    d, layers = cfg["d_model"], cfg["n_layers"]
    out = {"embed": ((_vocab_padded(cfg), d), 0.02),
           "final_ln": ((d,), "ones"),
           "lm_head": ((d, _vocab_padded(cfg)), 0.02)}

    def proj(d_in, d_out):
        return (layers, d_in, d_out), 1.0 / math.sqrt(d_in)

    if cfg["family"] == "ssm":
        s = cfg["ssm"]
        di, h, bc = s["d_inner"], s["n_heads"], 2 * s["n_groups"] * s["d_state"]
        out.update({
            "blocks/ln": ((layers, d), "ones"),
            "blocks/mixer/wz": proj(d, di),
            "blocks/mixer/wx": proj(d, di),
            "blocks/mixer/wbc": proj(d, bc),
            "blocks/mixer/wdt": proj(d, h),
            "blocks/mixer/conv_w": ((layers, 4, di + bc), 0.1),
            "blocks/mixer/conv_b": ((layers, di + bc), "zeros"),
            "blocks/mixer/A_log": ((layers, h), "a_log"),
            "blocks/mixer/D": ((layers, h), "ones"),
            "blocks/mixer/dt_bias": ((layers, h), "dt_bias"),
            "blocks/mixer/norm_g": ((layers, di), "ones"),
            "blocks/mixer/out_proj": proj(di, d),
        })
    elif cfg["family"] == "dense":
        hd = d // cfg["n_heads"]
        out.update({
            "blocks/ln1": ((layers, d), "ones"),
            "blocks/attn/wq": proj(d, cfg["n_heads"] * hd),
            "blocks/attn/wk": proj(d, cfg["n_kv_heads"] * hd),
            "blocks/attn/wv": proj(d, cfg["n_kv_heads"] * hd),
            "blocks/attn/wo": proj(cfg["n_heads"] * hd, d),
            "blocks/ln2": ((layers, d), "ones"),
            "blocks/ffn/wi": proj(d, cfg["d_ff"]),
            "blocks/ffn/wg": proj(d, cfg["d_ff"]),
            "blocks/ffn/wo": proj(cfg["d_ff"], d),
        })
    else:
        raise ValueError(f"weights are laid out for the dense and ssm families, got "
                         f"{cfg['family']!r}")
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """The nested parameter tree of one node."""
    lay = layout(cfg)
    random = [(p, shape, init) for p, (shape, init) in lay.items() if not isinstance(init, str)]
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
        if not isinstance(init, str):
            continue
        if init == "a_log":
            h = shape[-1]
            row = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=device))
            leaves[path] = row.expand(shape).clone()
        elif init == "dt_bias":
            leaves[path] = torch.full(shape, math.log(math.expm1(0.01)), dtype=torch.float32,
                                      device=device)
        else:
            fill = torch.ones if init == "ones" else torch.zeros
            leaves[path] = fill(shape, dtype=torch.float32, device=device)
    tree: dict = {}
    for path, leaf in leaves.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree

"""DeepSeek-V2 weights made by the benchmark from a configuration's weight
seed, for the program and the plain reference alike.

The tree has the port's checkpoint layout (``models/lm/deepseek_v2.py``:
layers stacked ``[L, ...]``, projections ``[in, out]``, experts ``[E, in,
out]``, the RoPE columns de-interleaved) and the distributions of a random
initialisation: each projection N(0, 1/d_in), the embedding and the head
N(0, 1/d), norm gains 1. Every random number comes from one generator
call on the device, in the type the model is served in; the leaves are
views of that one buffer (each starting on a 128-byte boundary), so the
card holds the weights once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Tree = Dict[str, Any]
_ALIGN = 64  # elements between leaf starts: 128 bytes in bf16


def leaf_specs(cfg: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf, in tree order; std 0 marks a norm
    gain (ones). ``cfg`` holds the published config keys."""
    d, n, v = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    nd = cfg["first_k_dense_replace"]
    nm, e, f = n - nd, cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    ff, fs = cfg["intermediate_size"], cfg["n_shared_experts"] * f
    return [
        (("tok_emb",), (v, d), d ** -0.5),
        (("blocks", "attn_norm"), (n, d), 0.0),
        (("blocks", "w_q"), (n, d, h * (nope + rope)), d ** -0.5),
        (("blocks", "w_kva"), (n, d, r + rope), d ** -0.5),
        (("blocks", "kv_norm"), (n, r), 0.0),
        (("blocks", "w_kvb"), (n, r, h * (nope + dv)), r ** -0.5),
        (("blocks", "w_o"), (n, h * dv, d), (h * dv) ** -0.5),
        (("blocks", "mlp_norm"), (n, d), 0.0),
        (("dense", "w_gate"), (nd, d, ff), d ** -0.5),
        (("dense", "w_up"), (nd, d, ff), d ** -0.5),
        (("dense", "w_down"), (nd, ff, d), ff ** -0.5),
        (("moe", "router"), (nm, d, e), d ** -0.5),
        (("moe", "w_gate"), (nm, e, d, f), d ** -0.5),
        (("moe", "w_up"), (nm, e, d, f), d ** -0.5),
        (("moe", "w_down"), (nm, e, f, d), f ** -0.5),
        (("moe", "shared_gate"), (nm, d, fs), d ** -0.5),
        (("moe", "shared_up"), (nm, d, fs), d ** -0.5),
        (("moe", "shared_down"), (nm, fs, d), fs ** -0.5),
        (("final_norm",), (d,), 0.0),
        (("lm_head",), (v, d), d ** -0.5),
    ]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def make_weights(cfg: Dict[str, Any], dtype: torch.dtype, device) -> Tree:
    """The configuration's weights (seed ``cfg['weight_seed']``) as a nested
    dict of tensors on ``device``."""
    specs = leaf_specs(cfg)
    total = sum(_padded(_numel(shape)) for _, shape, std in specs if std)
    gen = torch.Generator(device=device).manual_seed(int(cfg["weight_seed"]))
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: Tree = {}
    off = 0
    for path, shape, std in specs:
        if std:
            n = _numel(shape)
            leaf = buf[off: off + n].view(shape).mul_(std)
            off += _padded(n)
        else:
            leaf = torch.ones(shape, dtype=dtype, device=device)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def param_count(cfg: Dict[str, Any]) -> int:
    return sum(_numel(shape) for _, shape, _ in leaf_specs(cfg))

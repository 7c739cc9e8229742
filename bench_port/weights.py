"""Whisper weights made by the benchmark from a configuration's weight seed.

The benchmark makes the weights and hands the same tensors to the program
and to the plain reference, so neither takes the other's. The tree has
the checkpoint layout the port loads (``params.npz``: stacked ``[L, ...]``
layers, projections stored ``[in, out]``, the embedding padded to a
multiple of 128 rows with zero rows), and the distributions of a randomly
initialised Whisper: projections, convolutions and the token embedding
N(0, 1/d), positions N(0, 0.01^2), biases 0, norm gains 1. All random
numbers come from one generator call on the device, in the type they are
served in, so set-up stays short.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Tree = Dict[str, Any]


def padded_vocab(n_vocab: int) -> int:
    return ((n_vocab + 127) // 128) * 128


def _block_specs(prefix: Tuple[str, ...], d: int, ffn: int, layers: int, cross: bool):
    s = d ** -0.5
    out = []

    def attn(name):
        for w in ("q", "k", "v", "o"):
            out.append((prefix + (name, f"{w}_w"), (layers, d, d), "randn", s))
            if w != "k":  # Whisper's key projection has no bias
                out.append((prefix + (name, f"{w}_b"), (layers, d), "zeros", 0.0))

    def ln(name):
        out.append((prefix + (name, "g"), (layers, d), "ones", 0.0))
        out.append((prefix + (name, "b"), (layers, d), "zeros", 0.0))

    attn("attn")
    ln("attn_ln")
    if cross:
        attn("cross")
        ln("cross_ln")
    out += [
        (prefix + ("mlp", "fc1_w"), (layers, d, ffn), "randn", s),
        (prefix + ("mlp", "fc1_b"), (layers, ffn), "zeros", 0.0),
        (prefix + ("mlp", "fc2_w"), (layers, ffn, d), "randn", s),
        (prefix + ("mlp", "fc2_b"), (layers, d), "zeros", 0.0),
    ]
    ln("mlp_ln")
    return out


def leaf_specs(cfg: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str, float]]:
    """(path, shape, kind, std) of every leaf, in tree order."""
    d, n_mels = cfg["d_model"], cfg["num_mel_bins"]
    s = d ** -0.5
    enc = [
        (("encoder", "conv1", "w"), (d, n_mels, 3), "randn", s),
        (("encoder", "conv1", "b"), (d,), "zeros", 0.0),
        (("encoder", "conv2", "w"), (d, d, 3), "randn", s),
        (("encoder", "conv2", "b"), (d,), "zeros", 0.0),
    ]
    enc += _block_specs(("encoder", "blocks"), d, cfg["encoder_ffn_dim"], cfg["encoder_layers"],
                        False)
    enc += [(("encoder", "ln_post", "g"), (d,), "ones", 0.0),
            (("encoder", "ln_post", "b"), (d,), "zeros", 0.0)]
    dec = [
        (("decoder", "tok_emb"), (padded_vocab(cfg["vocab_size"]), d), "randn", s),
        (("decoder", "pos_emb"), (cfg["max_target_positions"], d), "randn", 0.01),
    ]
    dec += _block_specs(("decoder", "blocks"), d, cfg["decoder_ffn_dim"], cfg["decoder_layers"],
                        True)
    dec += [(("decoder", "ln", "g"), (d,), "ones", 0.0),
            (("decoder", "ln", "b"), (d,), "zeros", 0.0)]
    return enc + dec


def make_weights(cfg: Dict[str, Any], dtype: torch.dtype, device) -> Tree:
    """The configuration's weights (seed ``cfg['weight_seed']``) as a nested
    dict of tensors on ``device``."""
    specs = leaf_specs(cfg)
    n_random = sum(_numel(shape) for _, shape, kind, _ in specs if kind == "randn")
    gen = torch.Generator(device=device).manual_seed(int(cfg["weight_seed"]))
    buf = torch.randn(n_random, generator=gen, device=device, dtype=dtype)
    tree: Tree = {}
    off = 0
    for path, shape, kind, std in specs:
        if kind == "randn":
            n = _numel(shape)
            leaf = buf[off: off + n].view(shape).mul_(std).clone()
            off += n
        elif kind == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        else:
            leaf = torch.ones(shape, dtype=dtype, device=device)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    del buf
    tree["decoder"]["tok_emb"][cfg["vocab_size"]:] = 0  # the checkpoint's pad rows
    return tree


def leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf in tree order."""
    out: List[Tuple[str, torch.Tensor]] = []
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.extend(leaves(v, name) if isinstance(v, dict) else [(name, v)])
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n

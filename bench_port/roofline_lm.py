"""The LM cell's arithmetic: the model FLOPs of a request and the bytes a
decode step must read, from a DeepSeek-V2 configuration (published
``config.json`` keys) alone, so that a change to the program cannot move
them. The card's peaks, which the readers divide by, are ``roofline.py``'s.

Model FLOPs count each product once as the equations write it
(multiply-adds count 2): per token the projections, the dense or the
chosen experts' and the shared experts' SwiGLU and the router
(:func:`body_params`), the attention's scores and values over the
positions it sees, ``2 L H ctx (qk_head + v_head)``, and the output head
where logits are taken (the prefill takes them at its last position
only). A decode step must read, once each: the active weights (every
attention weight and norm, the dense layers, the router, the chosen
experts and the shared experts of every MoE layer, the token's embedding
row, the final norm and the head) and the latent cache at the live
context, and write its new latent rows.
"""

from __future__ import annotations

from typing import Any, Dict


def _attention_params(cfg: Dict[str, Any]) -> int:
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return d * h * (nope + rope) + d * (r + rope) + r * h * (nope + dv) + h * dv * d


def _mlp_params(cfg: Dict[str, Any], dense: bool) -> int:
    d = cfg["hidden_size"]
    if dense:
        return 3 * d * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    return (d * cfg["n_routed_experts"] + cfg["num_experts_per_tok"] * 3 * d * f
            + 3 * d * cfg["n_shared_experts"] * f)


def body_params(cfg: Dict[str, Any]) -> int:
    """Parameters one token multiplies by, outside the embedding and the head."""
    nl, nd = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    return (nl * _attention_params(cfg) + nd * _mlp_params(cfg, True)
            + (nl - nd) * _mlp_params(cfg, False))


def _attention_flops_per_ctx(cfg: Dict[str, Any]) -> int:
    """Every layer's scores and values for one query over one position."""
    return 2 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * (
        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])


def request_flops(cfg: Dict[str, Any], prompt: int, answer: int) -> float:
    """Model FLOPs of one request: the prefill over ``prompt`` tokens
    (causal, logits at its last position), then ``answer - 1`` decode steps,
    each at its live context with its logits."""
    body, head = 2.0 * body_params(cfg), 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    att = _attention_flops_per_ctx(cfg)
    prefill = body * prompt + att * prompt * (prompt + 1) / 2 + head
    steps = sum(body + att * (prompt + j) + head for j in range(1, answer))
    return prefill + steps


def decode_step_bytes(cfg: Dict[str, Any], ctx: int, itemsize: int = 2) -> float:
    """Bytes one decode step at live context ``ctx`` (the positions it
    attends, its own included) must move."""
    d, nl = cfg["hidden_size"], cfg["num_hidden_layers"]
    r, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    norms = nl * (2 * d + r) + d
    weights = body_params(cfg) + norms + d + cfg["vocab_size"] * d
    cache = nl * (ctx + 1) * (r + rope)  # read at the live context, the new rows written
    return float(itemsize * (weights + cache))

"""A plain DeepSeek-V2 forward in float32, the oracle of the port's
DeepSeek-V2 tests: plain ``torch`` operations, importing nothing of either
package, with TF32 off. It runs one sequence causally over all its
positions at once: no cache, no batching, no absorption of the latent
projections, the attention scores whole.

It follows the published modeling code of deepseek-ai/DeepSeek-V2-Lite
(``modeling_deepseek.py``; arXiv:2405.04434) for a configuration without a
query LoRA, with greedy top-k routing in one group. ``cfg`` holds the
published ``config.json`` keys. Departures from the paper and the code:

- The weights are a tree in the port's layout (layers stacked, projections
  ``[in, out]``, experts ``[E, in, out]``) rather than the checkpoint's
  ``[out, in]`` linears. With ``interleaved=True`` the RoPE columns are
  in the published order and are de-interleaved before ``rotate_half``,
  as the published code does; with ``interleaved=False`` they are stored
  de-interleaved already (as the port's converter stores them).
- The two shared experts are one SwiGLU of twice the expert width, as the
  published code builds them.
- Everything is f32 (the published model runs in bf16).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F


def set_exact_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def _mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_cos_sin(cfg: Dict[str, Any], n: int):
    """cos and sin ``[n, rope]`` of the published YaRN rotary embedding."""
    rs, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    pw = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    freq_extra, freq_inter = 1.0 / pw, 1.0 / (factor * pw)
    mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    freqs = torch.outer(torch.arange(n, dtype=torch.float32), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def _rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def _apply_rope(x, cos, sin, interleaved):
    if interleaved:
        d = x.shape[-1]
        x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    return x * cos + _rotate_half(x) * sin


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def forward(tree: Dict[str, Any], cfg: Dict[str, Any], tokens: torch.Tensor,
            interleaved: bool = False) -> Dict[str, torch.Tensor]:
    """tokens ``[T]`` -> ``logits [T, V]``, the latent ``c_kv [L, T, R]``
    (after its norm) and ``k_pe [L, T, rope]`` (after RoPE), and each MoE
    layer's chosen experts ``experts [Lm, T, k]`` (sorted ids)."""
    set_exact_f32()

    def f(t):
        return t.float()

    nl, h = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    r, eps, k_top = cfg["kv_lora_rank"], cfg["rms_norm_eps"], cfg["num_experts_per_tok"]
    dense_n = cfg["first_k_dense_replace"]
    m_all = cfg["rope_scaling"]["mscale_all_dim"]
    m = _mscale(cfg["rope_scaling"]["factor"], m_all) if m_all else 1.0
    scale = (nope + rope) ** -0.5 * m * m
    t = tokens.shape[0]
    cos, sin = yarn_cos_sin(cfg, t)
    causal = torch.full((t, t), float("-inf")).triu(1)
    x = f(tree["tok_emb"])[tokens]
    b, dn, mo = tree["blocks"], tree["dense"], tree["moe"]
    c_kvs, k_pes, chosen = [], [], []
    for i in range(nl):
        y = _rms(x, f(b["attn_norm"][i]), eps)
        q = (y @ f(b["w_q"][i])).view(t, h, nope + rope).transpose(0, 1)  # [H, T, 192]
        kva = y @ f(b["w_kva"][i])
        c_kv = _rms(kva[:, :r], f(b["kv_norm"][i]), eps)
        k_pe = _apply_rope(kva[:, r:], cos, sin, interleaved)  # [T, rope], one for all heads
        kv = (c_kv @ f(b["w_kvb"][i])).view(t, h, nope + dv).transpose(0, 1)
        q_pe = _apply_rope(q[..., nope:], cos, sin, interleaved)
        qq = torch.cat([q[..., :nope], q_pe], dim=-1)
        kk = torch.cat([kv[..., :nope], k_pe.expand(h, t, rope)], dim=-1)
        p = torch.softmax(qq @ kk.transpose(-1, -2) * scale + causal, dim=-1)
        o = (p @ kv[..., nope:]).transpose(0, 1).reshape(t, h * dv)
        x = x + o @ f(b["w_o"][i])
        c_kvs.append(c_kv)
        k_pes.append(k_pe)

        y = _rms(x, f(b["mlp_norm"][i]), eps)
        if i < dense_n:
            x = x + _swiglu(y, f(dn["w_gate"][i]), f(dn["w_up"][i]), f(dn["w_down"][i]))
            continue
        j = i - dense_n
        scores = torch.softmax(y @ f(mo["router"][j]), dim=-1)
        w, idx = torch.topk(scores, k_top, dim=-1)
        if cfg["norm_topk_prob"]:
            w = w / w.sum(-1, keepdim=True)
        w = w * cfg["routed_scaling_factor"]
        out = torch.zeros_like(x)
        for e in range(cfg["n_routed_experts"]):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel():
                ye = _swiglu(y[rows], f(mo["w_gate"][j][e]), f(mo["w_up"][j][e]),
                             f(mo["w_down"][j][e]))
                out.index_add_(0, rows, ye * w[rows, slot, None])
        out = out + _swiglu(y, f(mo["shared_gate"][j]), f(mo["shared_up"][j]),
                            f(mo["shared_down"][j]))
        x = x + out
        chosen.append(idx.sort(dim=-1).values)
    x = _rms(x, f(tree["final_norm"]), eps)
    return {"logits": x @ f(tree["lm_head"]).t(), "c_kv": torch.stack(c_kvs),
            "k_pe": torch.stack(k_pes), "experts": torch.stack(chosen)}

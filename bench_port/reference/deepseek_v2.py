"""The plain DeepSeek-V2 forward the LM cell's check runs at full size:
plain ``torch`` operations in f32 with TF32 off, importing nothing of the
program, over one whole sequence at once (no cache, no batching, no
absorption of the latent projections).

It follows the published modeling code of deepseek-ai/DeepSeek-V2-Lite
(``modeling_deepseek.py``; arXiv:2405.04434), as the CPU tests' copy
(``tests/deepseek_v2_ref.py``) does, and departs from it in the same ways:
the weights are the port's tree (projections ``[in, out]``, the RoPE
columns stored de-interleaved, so the half rotation needs no
de-interleaving), the two shared experts are one SwiGLU of twice the
width, and everything is f32. To fit the card beside the program's bf16
weights it works in blocks: one layer's weights are widened to f32 at a
time (all of them would take 63 GB), the attention runs query block by
query block over the keys up to the block's end, the experts one by one
over the tokens routed to them, and the output head only at the positions
asked for.

``prec`` "fp8" is the control one step below the configuration's bf16:
both operands of every product (projections, router, experts, head, the
attention's scores and values) rounded to float8 e4m3 with a per-tensor
scale; norms, softmaxes and sums stay f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value


def set_exact_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    x = x.float()
    if prec == "f32":
        return x
    if prec == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {prec}")


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def _mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_cos_sin(cfg: Dict[str, Any], n: int, device):
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
    inv_freq = (freq_inter * (1 - mask) + freq_extra * mask).to(device)
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def _rope(x, cos, sin):
    d = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., d:], x[..., :d]], dim=-1) * sin


def forward(tree: Dict[str, Any], cfg: Dict[str, Any], tokens: torch.Tensor, n_latent: int,
            logit_positions: Sequence[int], prec: str = "f32", q_block: int = 1024
            ) -> Dict[str, torch.Tensor]:
    """tokens ``[T]`` -> ``logits [len(logit_positions), V]`` (f32), the
    latent ``c_kv [L, n_latent, R]`` (after its norm) and ``k_pe [L,
    n_latent, rope]`` (after RoPE) of the first ``n_latent`` positions, and
    each MoE layer's chosen experts ``experts [Lm, T, k]`` (sorted ids)."""
    set_exact_f32()
    dev = tokens.device

    def mm(a, w):
        return _round(a, prec) @ _round(w, prec)

    def swiglu(x, wg, wu, wd):
        return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)

    nl, h = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    r, eps, k_top = cfg["kv_lora_rank"], cfg["rms_norm_eps"], cfg["num_experts_per_tok"]
    dense_n = cfg["first_k_dense_replace"]
    m_all = cfg["rope_scaling"]["mscale_all_dim"]
    m = _mscale(cfg["rope_scaling"]["factor"], m_all) if m_all else 1.0
    scale = (nope + rope) ** -0.5 * m * m
    t = tokens.shape[0]
    cos, sin = yarn_cos_sin(cfg, t, dev)
    x = tree["tok_emb"][tokens].float()
    b, dn, mo = tree["blocks"], tree["dense"], tree["moe"]
    c_kvs, k_pes, chosen = [], [], []
    for i in range(nl):
        y = _rms(x, b["attn_norm"][i], eps)
        q = mm(y, b["w_q"][i]).view(t, h, nope + rope).transpose(0, 1)  # [H, T, 192]
        kva = mm(y, b["w_kva"][i])
        c_kv = _rms(kva[:, :r], b["kv_norm"][i], eps)
        k_pe = _rope(kva[:, r:], cos, sin)  # [T, rope], shared by every head
        kv = mm(c_kv, b["w_kvb"][i]).view(t, h, nope + dv).transpose(0, 1)
        qq = _round(torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], dim=-1), prec)
        kk = _round(torch.cat([kv[..., :nope], k_pe.expand(h, t, rope)], dim=-1), prec)
        vv = _round(kv[..., nope:], prec)
        del q, kv
        o = torch.empty((h, t, dv), device=dev)
        for a in range(0, t, q_block):
            e = min(t, a + q_block)
            s = qq[:, a:e] @ kk[:, :e].transpose(-1, -2) * scale
            s += torch.full((e - a, e), float("-inf"), device=dev).triu(a + 1)
            o[:, a:e] = _round(torch.softmax(s, dim=-1), prec) @ vv[:, :e]
            del s
        del qq, kk, vv
        x = x + mm(o.transpose(0, 1).reshape(t, h * dv), b["w_o"][i])
        c_kvs.append(c_kv[:n_latent])
        k_pes.append(k_pe[:n_latent])

        y = _rms(x, b["mlp_norm"][i], eps)
        if i < dense_n:
            x = x + swiglu(y, dn["w_gate"][i], dn["w_up"][i], dn["w_down"][i])
            continue
        j = i - dense_n
        scores = torch.softmax(mm(y, mo["router"][j]), dim=-1)
        w, idx = torch.topk(scores, k_top, dim=-1)
        if cfg["norm_topk_prob"]:
            w = w / w.sum(-1, keepdim=True)
        w = w * cfg["routed_scaling_factor"]
        out = swiglu(y, mo["shared_gate"][j], mo["shared_up"][j], mo["shared_down"][j])
        for ex in range(cfg["n_routed_experts"]):
            rows, slot = torch.nonzero(idx == ex, as_tuple=True)
            if rows.numel():
                ye = swiglu(y[rows], mo["w_gate"][j][ex], mo["w_up"][j][ex], mo["w_down"][j][ex])
                out.index_add_(0, rows, ye * w[rows, slot, None])
        x = x + out
        chosen.append(idx.sort(dim=-1).values.to(torch.int16))
    pos = torch.as_tensor(list(logit_positions), device=dev)
    xl = _rms(x[pos], tree["final_norm"], eps)
    return {"logits": mm(xl, tree["lm_head"].t()), "c_kv": torch.stack(c_kvs),
            "k_pe": torch.stack(k_pes), "experts": torch.stack(chosen)}

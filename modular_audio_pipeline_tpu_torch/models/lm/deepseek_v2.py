"""DeepSeek-V2 causal LM in PyTorch: multi-head latent attention (MLA) over
a latent cache, a mixture of routed and shared SwiGLU experts, and YaRN
rotary positions.

The equations are those of the published modeling code of
deepseek-ai/DeepSeek-V2-Lite (``modeling_deepseek.py``; arXiv:2405.04434)
for a configuration without a query LoRA, with greedy top-k routing over
softmax scores in one group. Per layer, from ``h = RMSNorm(x)``:

- attention: ``q = h W_q``, per head ``[q_nope; q_pe]``; ``[c_kv; k_pe] =
  h W_kva``, ``c_kv = RMSNorm(c_kv)``; ``[k_nope; v] = c_kv W_kvb`` per
  head; RoPE (YaRN tables) on ``q_pe`` and on the one ``k_pe`` every head
  shares; ``o = softmax(scale (q_nope k_nope + q_pe k_pe) + causal) v`` with
  ``scale = (nope + rope)^-0.5 m^2``, ``m = 0.1 mscale_all_dim ln(factor) + 1``;
  ``x += concat_h(o) W_o``.
- feed-forward, from ``h = RMSNorm(x)``: the first ``first_k_dense`` layers
  a SwiGLU; the others route ``h W_g`` (f32) through a softmax over the
  experts, keep the greedy top ``k`` scores as the weights (renormalised
  only where ``norm_topk_prob``, times ``routed_scaling``), and add the
  shared experts' SwiGLU: ``y = sum_e w_e SwiGLU_e(h) + SwiGLU_shared(h)``.

Two attention paths. The prefill (several tokens) writes the new latent
rows into the cache, decompresses K and V from the cache and attends
query block by query block (``scaled_dot_product_attention`` with a
lower-right causal mask, scores and softmax in f32 inside it; on the card
only its fused routes are allowed, so no ``[H, S, S]`` score tensor is
ever built). The decode step (one token, :func:`decode_step`) attends over
the whole latent cache, the positions past its own masked, in the absorbed
form: ``q_lat = q_nope W_uk`` per head (``[H, kv_lora_rank]``), scores
``q_lat c_kv^T + q_pe k_pe^T``, ``o = (p c_kv) W_uv``, in f32. It reads its
position from a device tensor, so on the card ``generate`` captures it once
a request as a CUDA graph (:class:`DecodeGraph`) and replays it a step at a
time. The cache (:class:`MLACache`) holds ``c_kv`` after its norm and
``k_pe`` after RoPE, ``kv_lora_rank + rope`` values a token a layer (576 at
V2-Lite, where decompressed K and V would take 5,120), and is written in
place.

The routed experts run as grouped products (``torch._grouped_mm``) over
the token-expert pairs sorted by expert: the prefill groups its tokens by
expert, the decode step reads only the chosen experts' weights. The
routing stays on the card: no read-back inside the forward.

Precision: weights and activations in the parameters' type (bf16 on the
card); each product summed in f32 and rounded once to that type; the
router, the norms, the RoPE rotation, the attention scores and softmax,
the absorbed decode attention and the logits in f32; the experts'
weighted sum in f32, rounded once with the shared expert's output added.

Departures from the published code, none of which changes the result
beyond rounding:

- The published code de-interleaves the RoPE dimensions (pairs) of
  ``q_pe`` and ``k_pe`` before ``rotate_half``. Here the weight columns
  that produce them are stored de-interleaved (:func:`convert_hf_deepseek_v2`
  permutes them once), so the plain half rotation gives the same numbers.
- The shared experts are one SwiGLU of width ``n_shared x moe_d_ff``, as
  the published code builds them.
- The top-k is sorted (the published gate's is not): the chosen set and
  the weighted sum are the same.
- The SwiGLU's ``silu(gate) * up`` is taken in f32 (bf16 in the published
  code) and rounded once.

``deepseek-v2-lite`` takes its bos and eos ids (100000, 100001) from the
published config.json.

Checkpoints convert offline from the published safetensors
(:func:`convert_hf_deepseek_v2`) into the flat ``params.npz`` tree that
``LocalLMAnalyzer`` loads; ``test-small`` is a configuration for
mechanics tests with random weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...runtime import tracing
from ...utils import resolve_device

__all__ = ["DeepseekV2Config", "DEEPSEEK_V2_CONFIGS", "MLACache", "DeepseekV2LM", "forward",
           "decode_step", "DecodeGraph", "init_params", "yarn_inv_freq", "softmax_scale",
           "convert_hf_deepseek_v2", "rope_permutation"]

Params = Dict[str, Any]
Q_BLOCK = 2048  # the prefill's queries an attention call


@dataclass(frozen=True)
class DeepseekV2Config:
    n_layers: int
    d_model: int
    n_heads: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    kv_lora_rank: int
    d_ff: int  # the dense layers' SwiGLU width
    moe_d_ff: int  # one routed expert's width
    n_experts: int
    top_k: int
    n_shared: int
    first_k_dense: int
    vocab_size: int
    max_seq: int
    bos_id: int
    eos_id: int
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    routed_scaling: float = 1.0
    norm_topk_prob: bool = False
    rms_eps: float = 1e-6

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense


DEEPSEEK_V2_CONFIGS: Dict[str, DeepseekV2Config] = {
    # huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json
    "deepseek-v2-lite": DeepseekV2Config(
        n_layers=27, d_model=2048, n_heads=16, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        kv_lora_rank=512, d_ff=10944, moe_d_ff=1408, n_experts=64, top_k=6, n_shared=2,
        first_k_dense=1, vocab_size=102400, max_seq=163840, bos_id=100000, eos_id=100001),
    # a dense first layer, 8 experts top-2 and a shared expert; a short
    # original context, so that positions past it and the YaRN ramp are used
    "test-small": DeepseekV2Config(
        n_layers=3, d_model=64, n_heads=4, qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16,
        kv_lora_rank=32, d_ff=96, moe_d_ff=32, n_experts=8, top_k=2, n_shared=1,
        first_k_dense=1, vocab_size=512, max_seq=256, bos_id=1, eos_id=2, rope_factor=4.0,
        rope_original_max=64),
}


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (norm * g.float()).to(x.dtype)


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(cfg: DeepseekV2Config, device="cpu") -> Tuple[torch.Tensor, float]:
    """YaRN's inverse frequencies ``[rope / 2]`` (f32, as the published
    rotary embedding computes them), made on ``device``, and the factor on
    cos and sin: ``f_inter ramp + f_extra (1 - ramp)``, the ramp rising
    from the correction dimension of ``beta_fast`` (floored) to that of
    ``beta_slow`` (ceiled)."""
    d, base = cfg.qk_rope_dim, cfg.rope_theta
    expo = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    f_extra = 1.0 / (base ** expo)
    f_inter = 1.0 / (cfg.rope_factor * base ** expo)
    low = max(math.floor(_correction_dim(cfg.beta_fast, d, base, cfg.rope_original_max)), 0)
    high = min(math.ceil(_correction_dim(cfg.beta_slow, d, base, cfg.rope_original_max)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    inv_freq = f_inter * ramp + f_extra * (1 - ramp)
    m = (_yarn_mscale(cfg.rope_factor, cfg.mscale)
         / _yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))
    return inv_freq, m


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """``(nope + rope)^-0.5`` times YaRN's ``m^2`` (``mscale_all_dim``)."""
    m = _yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim) if cfg.mscale_all_dim else 1.0
    return cfg.qk_head_dim ** -0.5 * m * m


def _rope_tables(cfg: DeepseekV2Config, pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin ``[S, rope / 2]`` (f32) at positions ``pos [S]``."""
    inv_freq, m = yarn_inv_freq(cfg, pos.device)
    angles = pos[:, None].float() * inv_freq[None, :]
    return torch.cos(angles) * m, torch.sin(angles) * m


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The half rotation of x ``[..., S, rope]`` in f32, one rounding to x's type."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@dataclass
class MLACache:
    """Latent attention cache, written in place: ``c_kv [L, B, ctx,
    kv_lora_rank]`` (after its norm) and ``k_pe [L, B, ctx, rope]`` (after
    RoPE); ``pos`` the next write index (host int)."""

    c_kv: torch.Tensor
    k_pe: torch.Tensor
    pos: int = 0

    @staticmethod
    def zeros(cfg: DeepseekV2Config, batch: int, ctx: int, dtype: torch.dtype,
              device="cpu") -> "MLACache":
        return MLACache(
            torch.zeros((cfg.n_layers, batch, ctx, cfg.kv_lora_rank), dtype=dtype, device=device),
            torch.zeros((cfg.n_layers, batch, ctx, cfg.qk_rope_dim), dtype=dtype, device=device))


def _write_latent(cache: MLACache, layer: int, pos: torch.Tensor, c_kv: torch.Tensor,
                  k_pe: torch.Tensor) -> None:
    """The new tokens' latent rows into the cache at positions ``pos [S]``
    (a device tensor)."""
    cache.c_kv[layer].index_copy_(1, pos, c_kv)
    cache.k_pe[layer].index_copy_(1, pos, k_pe)


def _swiglu(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    act = F.silu(torch.matmul(h, w_gate).float()) * torch.matmul(h, w_up).float()
    return torch.matmul(act.to(h.dtype), w_down)


def _shared_expert(h: torch.Tensor, p: Params) -> torch.Tensor:
    return _swiglu(h, p["shared_gate"], p["shared_up"], p["shared_down"])


def _route(h: torch.Tensor, w_router: torch.Tensor, cfg: DeepseekV2Config
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert ids ``[N, k]`` and f32 weights ``[N, k]`` of tokens ``h [N, d]``:
    f32 logits, softmax over the experts, the greedy top ``k``."""
    scores = torch.softmax(torch.matmul(h.float(), w_router.float()), dim=-1)
    w, idx = torch.topk(scores, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return idx, w * cfg.routed_scaling


def _routed_experts(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, p: Params
                    ) -> torch.Tensor:
    """``sum_e w_e SwiGLU_e(h)`` in f32 ``[N, d]``: the token-expert pairs
    sorted by expert (stable), one grouped product per weight over the
    groups' row offsets (a group of no rows reads no weights), and the
    weighted rows added back to their tokens."""
    n, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token = order // k
    experts = torch.arange(p["w_gate"].shape[0], device=h.device, dtype=flat.dtype)
    offs = torch.searchsorted(flat[order], experts, right=True).to(torch.int32)
    xs = h[token]
    act = (F.silu(torch._grouped_mm(xs, p["w_gate"], offs=offs).float())
           * torch._grouped_mm(xs, p["w_up"], offs=offs).float()).to(h.dtype)
    ys = torch._grouped_mm(act, p["w_down"], offs=offs)
    out = torch.zeros((n, h.shape[-1]), dtype=torch.float32, device=h.device)
    return out.index_add_(0, token, ys.float() * w.reshape(-1)[order, None])


def _moe(h: torch.Tensor, p: Params, cfg: DeepseekV2Config) -> torch.Tensor:
    """The MoE layer on ``h [B, S, d]``."""
    b, s, d = h.shape
    flat = h.reshape(b * s, d)
    idx, w = _route(flat, p["router"], cfg)
    y = _routed_experts(flat, idx, w, p) + _shared_expert(flat, p).float()
    return y.to(h.dtype).reshape(b, s, d)


def _prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                       q_block: int) -> torch.Tensor:
    """Causal attention of the last ``S`` of ``T`` positions, query block by
    query block: q ``[B, H, S, Dqk]``, k ``[B, H, T, Dqk]``, v ``[B, H, T,
    Dv]`` -> ``[B, H, S, Dv]``. Each block sees the keys up to its own last
    position under a lower-right causal mask."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    s, t = q.shape[2], k.shape[2]
    out = q.new_empty(q.shape[:-1] + (v.shape[-1],))
    # on the card only the fused routes: the plain route would build the scores
    backends = ([SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
                if q.is_cuda else [SDPBackend.MATH])
    with sdpa_kernel(backends):
        for a in range(0, s, q_block):
            e = min(s, a + q_block)
            end = t - s + e
            out[:, :, a:e] = F.scaled_dot_product_attention(
                q[:, :, a:e], k[:, :, :end], v[:, :, :end],
                attn_mask=causal_lower_right(e - a, end), scale=scale)
    return out


def _absorbed_attention(q_nope: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                        k_pe: torch.Tensor, w_kvb: torch.Tensor, mask: torch.Tensor,
                        cfg: DeepseekV2Config) -> torch.Tensor:
    """One query a sequence over the latent cache, in f32: q_nope ``[B, H,
    nope]``, q_pe ``[B, H, rope]``, c_kv ``[B, T, R]``, k_pe ``[B, T, rope]``,
    the additive mask ``[T]`` -> ``[B, H, v]`` in q's type."""
    h, nope = cfg.n_heads, cfg.qk_nope_dim
    wkvb = w_kvb.float().view(cfg.kv_lora_rank, h, nope + cfg.v_head_dim)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.float(), wkvb[..., :nope])
    ckv = c_kv.float()
    scores = (torch.matmul(q_lat, ckv.transpose(1, 2))
              + torch.matmul(q_pe.float(), k_pe.float().transpose(1, 2))) * softmax_scale(cfg)
    scores = scores + mask
    o_lat = torch.matmul(torch.softmax(scores, dim=-1), ckv)
    return torch.einsum("bhr,rhv->bhv", o_lat, wkvb[..., nope:]).to(q_nope.dtype)


def _attention_input(x, blocks, l, cfg, cos, sin):
    """From the residual ``x [B, S, d]``: the queries ``[B, H, S, nope +
    rope]`` with RoPE on their last ``rope``, and the new latent rows:
    ``c_kv`` after its norm and ``k_pe`` after RoPE."""
    b, s, _ = x.shape
    nope, r = cfg.qk_nope_dim, cfg.kv_lora_rank
    y = _rms_norm(x, blocks["attn_norm"][l], cfg.rms_eps)
    q = torch.matmul(y, blocks["w_q"][l]).view(b, s, cfg.n_heads, cfg.qk_head_dim).transpose(1, 2)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], dim=-1)
    kva = torch.matmul(y, blocks["w_kva"][l])
    c_kv = _rms_norm(kva[..., :r], blocks["kv_norm"][l], cfg.rms_eps)
    return q, c_kv, _rope(kva[..., r:], cos, sin)


def _feed_forward(x, params, l, cfg):
    """``x`` plus layer ``l``'s feed-forward: the dense SwiGLU or the MoE."""
    blocks = params["blocks"]
    y = _rms_norm(x, blocks["mlp_norm"][l], cfg.rms_eps)
    if l < cfg.first_k_dense:
        p = params["dense"]
        return x + _swiglu(y, p["w_gate"][l], p["w_up"][l], p["w_down"][l])
    j = l - cfg.first_k_dense
    return x + _moe(y, {k: v[j] for k, v in params["moe"].items()}, cfg)


def _logits(params, cfg, x):
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    return torch.matmul(x.float(), params["lm_head"].float().t())


def routed_pairs(cfg: DeepseekV2Config, tokens: int) -> int:
    """Token-expert pairs the MoE layers route for ``tokens`` tokens."""
    return tokens * cfg.top_k * cfg.n_moe_layers


@torch.no_grad()
def forward(params: Params, cfg: DeepseekV2Config, tokens: torch.Tensor, cache: MLACache,
            q_block: int = Q_BLOCK, last_only: bool = False) -> Tuple[torch.Tensor, MLACache]:
    """Tokens ``[B, S]`` from ``cache.pos`` on -> (logits ``[B, S, V]`` f32,
    or ``[B, 1, V]`` of the last position with ``last_only``; the cache,
    written in place and advanced). One token takes the absorbed decode
    step (:func:`decode_step`), several the prefill path."""
    b, s = tokens.shape
    pos0 = cache.pos
    t = pos0 + s
    if t > cache.c_kv.shape[2]:
        raise ValueError(f"positions up to {t} do not fit a cache of {cache.c_kv.shape[2]}")
    tracing.count("moe.routed", routed_pairs(cfg, b * s))
    if s == 1:
        logits = decode_step(params, cfg, tokens, cache,
                             torch.tensor(pos0, dtype=torch.int64, device=tokens.device))
        cache.pos = t
        return logits, cache
    h, nope, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    scale = softmax_scale(cfg)
    x = params["tok_emb"][tokens]
    pos = pos0 + torch.arange(s, device=tokens.device)
    cos, sin = _rope_tables(cfg, pos)
    blocks = params["blocks"]

    for l in range(cfg.n_layers):
        q, c_kv, k_pe = _attention_input(x, blocks, l, cfg, cos, sin)
        _write_latent(cache, l, pos, c_kv, k_pe)
        kv = torch.matmul(cache.c_kv[l, :, :t], blocks["w_kvb"][l]).view(b, t, h, nope + dv)
        k_pe = cache.k_pe[l, :, None, :t].expand(b, h, t, cfg.qk_rope_dim)
        k = torch.cat([kv[..., :nope].transpose(1, 2), k_pe], dim=-1)
        v = kv[..., nope:].transpose(1, 2).contiguous()
        att = _prefill_attention(q, k, v, scale, q_block).transpose(1, 2).reshape(b, s, h * dv)
        x = _feed_forward(x + torch.matmul(att, blocks["w_o"][l]), params, l, cfg)

    cache.pos = t
    return _logits(params, cfg, x[:, -1:] if last_only else x), cache


@torch.no_grad()
def decode_step(params: Params, cfg: DeepseekV2Config, tokens: torch.Tensor, cache: MLACache,
                pos: torch.Tensor) -> torch.Tensor:
    """One token a sequence, ``tokens [B, 1]`` at position ``pos`` (a 0-d
    device tensor), over the whole cache with the positions past ``pos``
    masked -> logits ``[B, 1, V]`` f32; writes the token's latent rows. It
    reads no value on the host and its shapes do not change from step to
    step, so the card replays it as a CUDA graph (:class:`DecodeGraph`);
    ``cache.pos`` is the caller's to advance."""
    b = tokens.shape[0]
    ctx = cache.c_kv.shape[2]
    dv = cfg.v_head_dim
    x = params["tok_emb"][tokens]
    cos, sin = _rope_tables(cfg, pos[None])
    mask = torch.where(torch.arange(ctx, device=pos.device) <= pos, 0.0, float("-inf"))
    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        q, c_kv, k_pe = _attention_input(x, blocks, l, cfg, cos, sin)
        _write_latent(cache, l, pos[None], c_kv, k_pe)
        att = _absorbed_attention(q[:, :, 0, :cfg.qk_nope_dim], q[:, :, 0, cfg.qk_nope_dim:],
                                  cache.c_kv[l], cache.k_pe[l], blocks["w_kvb"][l], mask, cfg)
        x = x + torch.matmul(att.reshape(b, 1, cfg.n_heads * dv), blocks["w_o"][l])
        x = _feed_forward(x, params, l, cfg)
    return _logits(params, cfg, x)


class DecodeGraph:
    """:func:`decode_step` captured once as a CUDA graph over static
    buffers (the token, its position, the cache, the logits) and replayed
    a step at a time: one launch a step in place of the step's thousands.
    The warm-up call before the capture writes the cache's last position,
    which no step of a generation reads (the last token is not fed)."""

    def __init__(self, params: Params, cfg: DeepseekV2Config, cache: MLACache):
        dev = cache.c_kv.device
        self.tokens = torch.zeros((cache.c_kv.shape[1], 1), dtype=torch.int64, device=dev)
        self.pos = torch.full((), cache.c_kv.shape[2] - 1, dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            decode_step(params, cfg, self.tokens, cache, self.pos)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = decode_step(params, cfg, self.tokens, cache, self.pos)

    def __call__(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        return self.logits


def init_params(cfg: DeepseekV2Config, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16, device="cpu") -> Params:
    """Seeded random parameters in the checkpoint tree's layout (layers
    stacked ``[L, ...]``, projections ``[in, out]``, experts ``[E, in,
    out]``): each projection N(0, 1/d_in), the embedding and the head
    N(0, 1/d), norm gains 1."""
    d, n, nm, e = cfg.d_model, cfg.n_layers, cfg.n_moe_layers, cfg.n_experts
    h, r = cfg.n_heads, cfg.kv_lora_rank
    fs = cfg.n_shared * cfg.moe_d_ff

    def normal(*shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device) * fan_in ** -0.5).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "tok_emb": normal(cfg.vocab_size, d, fan_in=d),
        "blocks": {
            "attn_norm": ones(n, d),
            "w_q": normal(n, d, h * cfg.qk_head_dim, fan_in=d),
            "w_kva": normal(n, d, r + cfg.qk_rope_dim, fan_in=d),
            "kv_norm": ones(n, r),
            "w_kvb": normal(n, r, h * (cfg.qk_nope_dim + cfg.v_head_dim), fan_in=r),
            "w_o": normal(n, h * cfg.v_head_dim, d, fan_in=h * cfg.v_head_dim),
            "mlp_norm": ones(n, d),
        },
        "dense": {
            "w_gate": normal(cfg.first_k_dense, d, cfg.d_ff, fan_in=d),
            "w_up": normal(cfg.first_k_dense, d, cfg.d_ff, fan_in=d),
            "w_down": normal(cfg.first_k_dense, cfg.d_ff, d, fan_in=cfg.d_ff),
        },
        "moe": {
            "router": normal(nm, d, e, fan_in=d),
            "w_gate": normal(nm, e, d, cfg.moe_d_ff, fan_in=d),
            "w_up": normal(nm, e, d, cfg.moe_d_ff, fan_in=d),
            "w_down": normal(nm, e, cfg.moe_d_ff, d, fan_in=cfg.moe_d_ff),
            "shared_gate": normal(nm, d, fs, fan_in=d),
            "shared_up": normal(nm, d, fs, fan_in=d),
            "shared_down": normal(nm, fs, d, fan_in=fs),
        },
        "final_norm": ones(d),
        "lm_head": normal(cfg.vocab_size, d, fan_in=d),
    }


class DeepseekV2LM:
    """Generation over a preallocated latent cache."""

    def __init__(self, cfg: DeepseekV2Config, params: Optional[Params] = None, seed: int = 0,
                 device=None):
        """``params`` run where they lie; without them, random weights from
        ``seed`` are made on ``device`` (``None``: the card, which must be
        there; ``"cpu"`` asks for the CPU)."""
        self.cfg = cfg
        if params is None:
            dev = resolve_device(device)
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        self.params = params
        self.device = params["tok_emb"].device

    @torch.no_grad()
    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int = 256,
                 temperature: float = 0.3, eos_id: Optional[int] = None, seed: int = 0
                 ) -> np.ndarray:
        """Up to ``max_new_tokens`` tokens after ``prompt_ids``: greedy at
        temperature 0, else drawn by ``torch.multinomial`` from a generator
        seeded with ``seed``. Stops after emitting ``eos_id``, which is
        included; no step runs after the last token. On the card the decode
        steps replay one CUDA graph (:class:`DecodeGraph`, captured for each
        request's cache), elsewhere they run :func:`forward`. A request is
        the span ``lm.generate``, holding ``lm.prefill`` and ``lm.decode``
        (the decode loop, which starts after the graph's capture); the
        counter ``lm.decode_steps`` counts the decode loop's steps, and
        ``moe.routed`` the token-expert pairs routed."""
        cfg = self.cfg
        dev = self.params["tok_emb"].device
        prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64, device=dev)[None]
        ctx = prompt.shape[1] + max_new_tokens
        if ctx > cfg.max_seq:
            raise ValueError(f"{ctx} positions exceed the model's {cfg.max_seq}")
        out = []
        with tracing.span("lm.generate"):
            cache = MLACache.zeros(cfg, 1, ctx, self.params["tok_emb"].dtype, dev)
            gen = torch.Generator(device=dev).manual_seed(seed) if temperature > 0 else None
            with tracing.span("lm.prefill"):
                logits, cache = forward(self.params, cfg, prompt, cache, last_only=True)
                last = logits[:, -1]
            step = (DecodeGraph(self.params, cfg, cache)
                    if dev.type == "cuda" and max_new_tokens > 1 else None)
            with tracing.span("lm.decode"):
                for i in range(max_new_tokens):
                    if temperature > 0:
                        tok = torch.multinomial(torch.softmax(last / temperature, dim=-1), 1,
                                                generator=gen)
                    else:
                        tok = last.argmax(dim=-1, keepdim=True)
                    out.append(int(tok))
                    if out[-1] == eos_id or i == max_new_tokens - 1:
                        break
                    tracing.count("lm.decode_steps")
                    last = _decode(step, self.params, cfg, tok, cache)[:, -1]
        return np.asarray(out, dtype=np.int32)


def _decode(step: Optional[DecodeGraph], params: Params, cfg: DeepseekV2Config,
            tokens: torch.Tensor, cache: MLACache) -> torch.Tensor:
    """One decode step of ``tokens [B, 1]``: a replay of the captured graph
    where there is one (on the card), else :func:`forward`; advances the
    cache. Returns the logits ``[B, 1, V]``."""
    if step is None:
        return forward(params, cfg, tokens, cache)[0]
    tracing.count("moe.routed", routed_pairs(cfg, tokens.shape[0]))
    logits = step(tokens, cache.pos)
    cache.pos += 1
    return logits


def rope_permutation(rope: int) -> np.ndarray:
    """Column order that stores the published interleaved RoPE pairs
    de-interleaved: the even dimensions, then the odd ones."""
    return np.concatenate([np.arange(0, rope, 2), np.arange(1, rope, 2)])


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """A tensor as bf16 bits (``uint16``): BF16 as read (its bits), other
    float types rounded to bf16 once."""
    if x.dtype == np.uint16:
        return x
    t = torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _save_rowwise(path, leaves: Dict[str, Any]) -> None:
    """An ``.npz`` written an array at a time: ``leaves`` maps each flat key
    to an array or to a list of functions, one for each row of the leading
    axis (a layer), each made, written and dropped before the next."""
    import zipfile

    with zipfile.ZipFile(path, "w", allowZip64=True) as zf:
        for key, rows in leaves.items():
            with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                if not isinstance(rows, list):
                    np.lib.format.write_array(f, np.ascontiguousarray(rows))
                    continue
                row = np.ascontiguousarray(rows[0]())
                head = np.lib.format.header_data_from_array_1_0(row)
                head["shape"] = (len(rows),) + row.shape
                np.lib.format.write_array_header_2_0(f, head)
                f.write(row.tobytes())
                for make in rows[1:]:
                    f.write(np.ascontiguousarray(make(), dtype=row.dtype).tobytes())


def convert_hf_deepseek_v2(src: str, dst: str, model_name: str) -> None:
    """Published DeepSeek-V2 safetensors -> the flat ``params.npz`` tree,
    offline, in bf16 (``uint16`` bits, which ``LM_MODELS``' loader reads as
    bf16). Tensors are read through the port's
    ``models/safetensors_reader.py`` as memory maps, BF16 as its bits; one
    layer's tensor of one leaf (at most the 64 experts' ``w_gate`` of a
    layer, 369 MB at V2-Lite) is in memory at a time, so the host needs
    little more than the page cache. Linear weights ``[out, in]`` are
    stored ``[in, out]``; the RoPE columns of ``q_proj`` (each head's last
    ``rope``) and of ``kv_a_proj_with_mqa`` (its last ``rope``) are
    permuted by :func:`rope_permutation`."""
    from pathlib import Path

    from ..safetensors_reader import load_safetensors

    cfg = DEEPSEEK_V2_CONFIGS[model_name]
    sd: Dict[str, np.ndarray] = {}
    for f in sorted(Path(src).glob("*.safetensors")):
        sd.update(load_safetensors(f, bf16_bits=True))

    def g(k):
        return _bf16_bits(sd[k])

    h, nope, rope, r = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    perm = rope_permutation(rope)
    q_cols = np.concatenate([hh * cfg.qk_head_dim + np.concatenate([np.arange(nope), nope + perm])
                             for hh in range(h)])
    kva_cols = np.concatenate([np.arange(r), r + perm])
    layer = "model.layers.{}.".format
    dense = range(cfg.first_k_dense)
    moe = range(cfg.first_k_dense, cfg.n_layers)

    def rows(layers, make):
        return [lambda i=i: make(layer(i)) for i in layers]

    def proj(name, cols=None):
        return lambda p: g(p + name).T if cols is None else g(p + name).T[:, cols]

    def experts(w):
        return lambda p: np.stack([g(f"{p}mlp.experts.{e}.{w}_proj.weight").T
                                   for e in range(cfg.n_experts)])

    leaves: Dict[str, Any] = {
        "tok_emb": g("model.embed_tokens.weight"),
        "blocks/attn_norm": rows(range(cfg.n_layers), lambda p: g(p + "input_layernorm.weight")),
        "blocks/w_q": rows(range(cfg.n_layers), proj("self_attn.q_proj.weight", q_cols)),
        "blocks/w_kva": rows(range(cfg.n_layers),
                             proj("self_attn.kv_a_proj_with_mqa.weight", kva_cols)),
        "blocks/kv_norm": rows(range(cfg.n_layers),
                               lambda p: g(p + "self_attn.kv_a_layernorm.weight")),
        "blocks/w_kvb": rows(range(cfg.n_layers), proj("self_attn.kv_b_proj.weight")),
        "blocks/w_o": rows(range(cfg.n_layers), proj("self_attn.o_proj.weight")),
        "blocks/mlp_norm": rows(range(cfg.n_layers),
                                lambda p: g(p + "post_attention_layernorm.weight")),
        **{f"dense/w_{w}": rows(dense, proj(f"mlp.{w}_proj.weight"))
           for w in ("gate", "up", "down")},
        "moe/router": rows(moe, proj("mlp.gate.weight")),
        **{f"moe/w_{w}": rows(moe, experts(w)) for w in ("gate", "up", "down")},
        **{f"moe/shared_{w}": rows(moe, proj(f"mlp.shared_experts.{w}_proj.weight"))
           for w in ("gate", "up", "down")},
        "final_norm": g("model.norm.weight"),
        "lm_head": g("lm_head.weight"),
    }
    Path(dst).mkdir(parents=True, exist_ok=True)
    _save_rowwise(Path(dst) / "params.npz", leaves)

"""Llama-architecture causal LM in PyTorch (RMSNorm, RoPE, GQA, SwiGLU).

Counterpart of ``modular_audio_pipeline_tpu/models/lm/llama.py``, with the
same parameter tree (stacked ``[L, ...]`` layers, projections ``[in,
out]``), so a converted ``params.npz`` loads in either package. It keeps
the JAX arithmetic: weights and activations in the parameters' type (bf16
on the card), every product summed in f32 and rounded once to that type;
the SwiGLU gate and up products, the attention scores and the logits stay
f32, as the JAX einsums with ``preferred_element_type=float32`` leave
them. The JAX LM has no Pallas kernel: its products and attention are
plain einsums, so here they are ``torch.matmul`` and an explicit softmax
(not ``scaled_dot_product_attention``, which rounds otherwise). GQA
repeats the KV heads; the mask is additive ``-inf`` over the whole cache.

Checkpoints convert offline from HF safetensors (:func:`convert_hf_llama`);
``test-small`` is a config for mechanics tests with random weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...runtime import tracing

__all__ = ["LlamaConfig", "LLAMA_CONFIGS", "LMCache", "LlamaLM", "forward", "init_params",
           "params_from_jax", "convert_hf_llama"]

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    max_seq: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


LLAMA_CONFIGS: Dict[str, LlamaConfig] = {
    "tinyllama-1.1b": LlamaConfig(22, 2048, 32, 4, 5632, 32000),
    "mistral-7b": LlamaConfig(32, 4096, 32, 8, 14336, 32000, max_seq=4096),
    "test-small": LlamaConfig(2, 64, 4, 2, 128, 512, max_seq=128),
}


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (norm * g.float()).to(x.dtype)


def _rope_tables(pos: torch.Tensor, d: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rotary angles' cos and sin ``[1, 1, S, D/2]`` for absolute
    positions ``pos [S]``, in f32 (the JAX package rounds its f64 inverse
    frequencies to f32). Built once per forward and shared by every layer."""
    inv_freq = torch.from_numpy((1.0 / (theta ** (np.arange(0, d, 2) / d))).astype(np.float32))
    angles = pos[:, None].float() * inv_freq.to(pos.device)[None, :]
    return torch.cos(angles)[None, None], torch.sin(angles)[None, None]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x ``[B, H, S, D]`` by :func:`_rope_tables`' cos and
    sin: the rotation in f32, then one rounding to x's type."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@dataclass
class LMCache:
    """Preallocated self-attention cache, updated in place: ``k``/``v``
    ``[L, B, KVH, ctx, hd]``, ``pos`` the next write index (host int)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0

    @staticmethod
    def zeros(cfg: LlamaConfig, batch: int, ctx: int, dtype: torch.dtype,
              device="cpu") -> "LMCache":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, ctx, cfg.head_dim)
        return LMCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` left in f32 (the operands' values are exact in f32); a
    plain ``torch.matmul`` sums in f32 and rounds once to the operands'
    type."""
    return torch.matmul(a.float(), w.float())


@torch.no_grad()
def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, cache: LMCache
            ) -> Tuple[torch.Tensor, LMCache]:
    """Teacher-forced or incremental forward: tokens ``[B, S]`` from
    ``cache.pos`` on -> (logits ``[B, S, V]`` f32, the cache, written in
    place and advanced). A write past the cache's end lands on its last
    rows, as the JAX package's ``dynamic_update_slice`` clamps it."""
    b, s = tokens.shape
    ctx = cache.k.shape[-2]
    pos0 = cache.pos
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    groups = h // kvh
    dev = tokens.device

    x = params["tok_emb"][tokens]
    positions = pos0 + torch.arange(s, device=dev)
    cos, sin = _rope_tables(positions, hd, cfg.rope_theta)
    k_pos = torch.arange(ctx, device=dev)[None, :]
    mask = torch.where(k_pos <= positions[:, None], 0.0, float("-inf"))  # [S, ctx] f32
    wpos = max(0, min(pos0, ctx - s))
    blocks = params["blocks"]

    for l in range(cfg.n_layers):
        p = {name: t[l] for name, t in blocks.items()}
        resid = x
        y = _rms_norm(x, p["attn_norm"], cfg.rms_eps)

        def heads(w, n):
            return torch.matmul(y, w).reshape(b, s, n, hd).transpose(1, 2)

        q = _rope(heads(p["wq"], h), cos, sin)
        cache.k[l, :, :, wpos : wpos + s] = _rope(heads(p["wk"], kvh), cos, sin)
        cache.v[l, :, :, wpos : wpos + s] = heads(p["wv"], kvh)

        kk = cache.k[l].repeat_interleave(groups, dim=1)  # GQA: [B, H, ctx, hd]
        vv = cache.v[l].repeat_interleave(groups, dim=1)
        scores = _mm_f32(q * hd ** -0.5, kk.transpose(-1, -2)) + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        att = torch.matmul(probs, vv).transpose(1, 2).reshape(b, s, h * hd)
        x = resid + torch.matmul(att, p["wo"])

        resid = x
        y = _rms_norm(x, p["mlp_norm"], cfg.rms_eps)
        act = (F.silu(_mm_f32(y, p["w_gate"])) * _mm_f32(y, p["w_up"])).to(x.dtype)
        x = resid + torch.matmul(act, p["w_down"])

    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _mm_f32(x, params["lm_head"].t())
    cache.pos = pos0 + s
    return logits, cache


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16, device="cpu") -> Params:
    """Seeded random parameters with the checkpoint tree's layout, drawn
    on ``device`` from ``generator`` (which must live there). The
    distributions follow the JAX package's ``init_params``; the numbers
    differ (another generator)."""
    d, ff, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    s = d ** -0.5

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device) * s).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {
        "tok_emb": normal(cfg.vocab_size, d),
        "blocks": {
            "attn_norm": ones(n, d),
            "wq": normal(n, d, hq), "wk": normal(n, d, hkv), "wv": normal(n, d, hkv),
            "wo": normal(n, hq, d),
            "mlp_norm": ones(n, d),
            "w_gate": normal(n, d, ff), "w_up": normal(n, d, ff), "w_down": normal(n, ff, d),
        },
        "final_norm": ones(d),
        "lm_head": normal(cfg.vocab_size, d),
    }


def params_from_jax(tree: Params, device="cpu", dtype: torch.dtype = torch.bfloat16) -> Params:
    """The JAX package's parameter tree as numpy arrays (``np.asarray`` over
    its leaves, or ``params.npz``) -> the same tree of tensors."""
    from ..whisper.convert import params_from_numpy

    return params_from_numpy(tree, device, dtype)


class LlamaLM:
    """Generation over a preallocated KV cache."""

    def __init__(self, cfg: LlamaConfig, params: Optional[Params] = None, seed: int = 0,
                 device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, device=self.device)
        self.params = params

    @torch.no_grad()
    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int = 256,
                 temperature: float = 0.3, eos_id: Optional[int] = None, seed: int = 0
                 ) -> np.ndarray:
        """Up to ``max_new_tokens`` tokens after ``prompt_ids``: greedy at
        temperature 0, else drawn by ``torch.multinomial`` from a generator
        seeded with ``seed``. Stops after emitting ``eos_id``, which is
        included, as in the JAX package (whose samples differ: another
        generator). A request is the span ``lm.generate``, holding
        ``lm.prefill`` and ``lm.decode``; the counter ``lm.decode_steps``
        counts the decode loop's forwards."""
        cfg = self.cfg
        dev = self.params["tok_emb"].device
        prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64, device=dev)[None]
        ctx = min(cfg.max_seq, prompt.shape[1] + max_new_tokens + 1)
        out = []
        with tracing.span("lm.generate"):
            cache = LMCache.zeros(cfg, 1, ctx, self.params["tok_emb"].dtype, dev)
            with tracing.span("lm.prefill"):
                logits, cache = forward(self.params, cfg, prompt, cache)
                last = logits[:, -1]
            gen = torch.Generator(device=dev).manual_seed(seed) if temperature > 0 else None
            with tracing.span("lm.decode"):
                for _ in range(max_new_tokens):
                    if temperature > 0:
                        tok = torch.multinomial(torch.softmax(last / temperature, dim=-1), 1,
                                                generator=gen)[0, 0]
                    else:
                        tok = last[0].argmax()  # first max, as jnp.argmax
                    tok = int(tok)
                    out.append(tok)
                    if tok == eos_id:
                        break
                    tracing.count("lm.decode_steps")
                    logits, cache = forward(
                        self.params, cfg, torch.tensor([[tok]], dtype=torch.int64, device=dev),
                        cache)
                    last = logits[:, -1]
        return np.asarray(out, dtype=np.int32)


def convert_hf_llama(src: str, dst: str, model_name: str) -> None:
    """HF llama/mistral safetensors -> the flat ``params.npz`` tree
    (offline; the JAX package's converter, copied, reading the files with
    the port's own ``models/safetensors_reader.py``: no ``safetensors``
    package). BF16 tensors are widened to f32 exactly, as the JAX
    converter widens them through ``ml_dtypes``."""
    from pathlib import Path

    from ..safetensors_reader import load_safetensors
    from ..whisper.convert import save_params

    cfg = LLAMA_CONFIGS[model_name]
    sd: Dict[str, np.ndarray] = {}
    for f in sorted(Path(src).glob("*.safetensors")):
        sd.update(load_safetensors(f, bf16_as_f32=True))

    def g(k):
        return sd[k].astype(np.float32)

    blocks = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        blocks.append({
            "attn_norm": g(f"{p}.input_layernorm.weight"),
            "wq": g(f"{p}.self_attn.q_proj.weight").T,
            "wk": g(f"{p}.self_attn.k_proj.weight").T,
            "wv": g(f"{p}.self_attn.v_proj.weight").T,
            "wo": g(f"{p}.self_attn.o_proj.weight").T,
            "mlp_norm": g(f"{p}.post_attention_layernorm.weight"),
            "w_gate": g(f"{p}.mlp.gate_proj.weight").T,
            "w_up": g(f"{p}.mlp.up_proj.weight").T,
            "w_down": g(f"{p}.mlp.down_proj.weight").T,
        })
    params = {
        "tok_emb": g("model.embed_tokens.weight"),
        "blocks": {key: np.stack([blk[key] for blk in blocks]) for key in blocks[0]},
        "final_norm": g("model.norm.weight"),
        # tied embeddings when the checkpoint has no head of its own
        "lm_head": g("lm_head.weight" if "lm_head.weight" in sd else "model.embed_tokens.weight"),
    }
    save_params(params, dst)

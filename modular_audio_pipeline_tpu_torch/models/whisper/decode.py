"""Batched Whisper decoding: beam search and greedy with a KV cache (PyTorch).

Counterpart of ``modular_audio_pipeline_tpu/models/whisper/decode.py``.
The JAX package runs each cache-size stage as one ``lax.while_loop``; here
the loop runs on the host, one step at a time, and its condition is read
back from the device once per step. Everything else keeps the JAX
package's semantics:

- a static token budget (``max_tokens``) and staged context buckets that
  grow the cache by 64 slots (:func:`_stage_bounds`);
- logit filters as vectorised masks (suppress-blank, suppress-non-speech,
  the timestamp grammar of :func:`_apply_timestamp_rules`);
- beams folded into the batch dimension ``[B*K]``, the live/finished-pool
  beam search with patience, and ancestry-indexed attention that never
  permutes the KV cache (``ancestry=True``).

Sampling at ``temperature > 0`` (the rungs of the transcriber's fallback
ladder) draws from an explicit ``torch.Generator`` on the tensors' device,
where the JAX package splits a PRNG key: the two draw different numbers,
so sampled tokens are reproducible per seed, not equal across packages.

Where the JAX package selects rows with one-hot "exact einsums" (a TPU
matmul-precision workaround), the port gathers with integer indices,
which is exact by construction. Top-k selection breaks ties toward the
lower flat index, as JAX's ``top_k``/``approx_max_k`` do, by a stable sort.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...runtime.integrity import checksum_device, fetch_verified_many
from .config import WhisperDims
from .model import (
    KVCache,
    _quantize_rows,
    cross_kv,
    decoder_forward,
    encoder_forward,
    local_heads,
)
from .tokenizer import LANGUAGES, WhisperTokenizer

__all__ = [
    "DecodeOptions", "DecodeResult", "decode_windows", "finalize_decode",
    "encode_audio_kv", "build_initial_tokens", "detect_language",
]

_NEG_INF = -1e9


@dataclass(frozen=True)
class DecodeOptions:
    """Decoding controls (same fields and defaults as the JAX package)."""

    language: str = "en"
    task: str = "transcribe"
    beam_size: int = 1
    temperature: float = 0.0
    max_tokens: int = 224
    timestamps: bool = True
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    suppress_non_speech: bool = True
    suppress_tokens: Tuple[int, ...] = ()
    prompt_tokens: Tuple[int, ...] = ()
    length_penalty: Optional[float] = None  # None => simple length norm
    patience: Optional[float] = None  # finished pool = round(beam_size * patience)
    kv_int8: bool = True  # int8 self-attention KV cache
    ancestry: bool = True  # ancestry-indexed beam attention (no cache permute)


class DecodeResult(NamedTuple):
    tokens: np.ndarray  # [B, max_tokens] int32, EOT-padded
    lengths: np.ndarray  # [B] valid token counts (excl. EOT)
    sum_logprobs: np.ndarray  # [B]
    avg_logprobs: np.ndarray  # [B]
    no_speech_probs: np.ndarray  # [B]


def encode_audio_kv(params, dims: WhisperDims, mel: torch.Tensor):
    """mel [B, n_mels, 3000] -> (xa_k, xa_v), each [L, B, H, 1500, hd]."""
    return cross_kv(params, dims, encoder_forward(params, dims, mel))


def _quantize_cross_kv(xa_k, xa_v):
    """Per-position int8 copies of the cross-attention K/V, quantised once
    per batch: the decode loop reads the audio K/V every step."""
    return _quantize_rows(xa_k), _quantize_rows(xa_v)


def _build_filter_tables(tok: WhisperTokenizer, opts: DecodeOptions, n_vocab: int, device):
    """Suppression and blank masks (bool [V]), cached per tokenizer,
    the options they depend on, and device."""
    return _build_filter_tables_cached(
        tok, opts.suppress_non_speech, tuple(opts.suppress_tokens),
        opts.timestamps, n_vocab, str(device),
    )


@lru_cache(maxsize=16)
def _build_filter_tables_cached(tok, suppress_non_speech, suppress_tokens, timestamps,
                                n_vocab, device):
    suppress = np.zeros(n_vocab, dtype=bool)
    special = [
        tok.sot, tok.special.sot_lm, tok.sot_prev, tok.no_speech,
        tok.special.translate, tok.special.transcribe,
    ] + [tok.special.language_start + i for i in range(tok.special.n_languages)]
    for t in special:
        if t < n_vocab:
            suppress[t] = True
    if suppress_non_speech:
        for t in tok.non_speech_tokens():
            suppress[t] = True
    for t in suppress_tokens:
        if 0 <= t < n_vocab:
            suppress[t] = True
    if timestamps:
        suppress[tok.no_timestamps] = True

    blank = np.zeros(n_vocab, dtype=bool)
    for t in tok.encode(" ") + [tok.eot]:
        blank[t] = True
    return torch.from_numpy(suppress).to(device), torch.from_numpy(blank).to(device)


def _apply_timestamp_rules(
    logprobs: torch.Tensor,  # [B, V] f32
    last_tok: torch.Tensor,  # [B]
    penult_tok: torch.Tensor,  # [B]
    max_ts_tok: torch.Tensor,  # [B] highest timestamp token emitted so far
    step_idx: int,  # tokens generated so far (0 on the first)
    ts_begin: int,
    eot: int,
    max_initial_ts_tok: int,
) -> torch.Tensor:
    """Whisper's timestamp grammar as one vectorised mask pass. Masks add
    ``-1e9`` terms in the same order as the JAX function, so the filtered
    values are the same floats."""
    v = logprobs.shape[-1]
    ids = torch.arange(v, device=logprobs.device)
    is_ts = ids >= ts_begin  # [V]
    zero = torch.zeros((), device=logprobs.device)
    neg = torch.full((), _NEG_INF, device=logprobs.device)

    last_was_ts = last_tok >= ts_begin
    penult_was_ts = penult_tok >= ts_begin

    # 1. after <ts><ts> or at text: next cannot be a timestamp;
    #    after a single <ts>: next must be a timestamp or EOT.
    forbid_ts = last_was_ts & penult_was_ts
    force_ts = last_was_ts & ~penult_was_ts
    mask = torch.where(forbid_ts[:, None] & is_ts[None, :], neg, zero)
    not_ts_not_eot = (~is_ts) & (ids != eot)
    mask = mask + torch.where(force_ts[:, None] & not_ts_not_eot[None, :], neg, zero)

    # 2. timestamps are non-decreasing: after a completed pair the next
    #    start must be strictly greater; right after a single timestamp its
    #    pair end may equal it.
    cutoff = torch.clamp(max_ts_tok + (~force_ts).to(max_ts_tok.dtype), min=ts_begin)
    below = ids[None, :] < cutoff[:, None]
    mask = mask + torch.where(below & is_ts[None, :], neg, zero)

    # 3. the first generated token is a timestamp, at most max_initial_ts.
    if step_idx == 0:
        mask = mask + torch.where(not_ts_not_eot[None, :], neg, zero)
        mask = mask + torch.where((ids[None, :] > max_initial_ts_tok) & is_ts[None, :], neg, zero)

    filtered = logprobs + mask

    # 4. if the total timestamp probability beats the best text token,
    #    force a timestamp.
    ts_logprob = torch.logsumexp(torch.where(is_ts[None, :], filtered, neg), dim=-1)
    max_text = torch.where(is_ts[None, :], neg, filtered).amax(dim=-1)
    force = ts_logprob > max_text
    return filtered + torch.where(force[:, None] & (~is_ts)[None, :], neg, zero)


def _stage_bounds(p: int, max_new: int, n_text_ctx: int) -> List[Tuple[int, int]]:
    """Bucketed decode schedule: ``[(stage_end_token, cache_ctx)]``.

    The KV cache starts at the smallest 64-multiple that fits the prompt
    plus the first tokens and grows by 64-slot buckets between stages, so
    per-step costs that scale with cache capacity track the live context.
    """
    bounds: List[Tuple[int, int]] = []
    t = 0
    while t < max_new:
        ctx = min(n_text_ctx, ((p + t + 64) // 64) * 64)
        t_next = max_new if ctx >= n_text_ctx else min(max_new, ctx - p)
        bounds.append((t_next, ctx))
        t = t_next
    return bounds


def _pad_cache(cache: KVCache, ctx: int) -> KVCache:
    cur = cache.k.shape[-2]
    if cur == ctx:
        return cache
    pad5, pad4 = (0, 0, 0, ctx - cur), (0, ctx - cur)
    return KVCache(
        k=F.pad(cache.k, pad5),
        v=F.pad(cache.v, pad5),
        pos=cache.pos,
        k_scale=None if cache.k_scale is None else F.pad(cache.k_scale, pad4),
        v_scale=None if cache.v_scale is None else F.pad(cache.v_scale, pad4),
    )


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _filtered_logprobs(prev_logits, i, last, penult, max_ts, suppress, blank, o):
    logprobs = torch.log_softmax(prev_logits, dim=-1)
    neg = torch.full((), _NEG_INF, device=logprobs.device)
    lp = torch.where(suppress[None, :], neg, logprobs)
    if i == 0 and o["suppress_blank"]:
        lp = torch.where(blank[None, :], neg, lp)
    if o["timestamps"]:
        lp = _apply_timestamp_rules(
            lp, last, penult, max_ts, i, o["ts_begin"], o["eot"], o["max_initial_ts_tok"]
        )
    return lp


# ---------------------------------------------------------------------------
# Greedy
# ---------------------------------------------------------------------------

def _greedy_prefill(params, dims, xa_k, xa_v, initial_tokens, sot_index, o, ctx0):
    """Prompt pass -> (loop state, no_speech_prob)."""
    b = initial_tokens.shape[0]
    dev = initial_tokens.device
    cache = KVCache.zeros(dims, b, params["decoder"]["tok_emb"].dtype, ctx=ctx0,
                          quant=o["kv_int8"], device=dev,
                          heads=local_heads(dims.n_text_head, params))
    logits, cache = decoder_forward(params, dims, initial_tokens, xa_k, xa_v, cache)
    no_speech_prob = torch.softmax(logits[:, sot_index], dim=-1)[:, o["no_speech"]]
    state = {
        "i": 0, "cache": cache,
        "out_tokens": torch.full((b, o["max_tokens"]), o["eot"], dtype=torch.int64, device=dev),
        "last": initial_tokens[:, -1].clone(),
        # openai's sampled-only penultimate convention: a timestamp sentinel
        # rather than the prompt tail (see the JAX module).
        "penult": torch.full((b,), o["ts_begin"], dtype=torch.int64, device=dev),
        "max_ts": torch.zeros((b,), dtype=torch.int64, device=dev),
        "done": torch.zeros((b,), dtype=torch.bool, device=dev),
        "sum_lp": torch.zeros((b,), dtype=torch.float32, device=dev),
        "prev_logits": logits[:, -1],
    }
    return state, no_speech_prob


def _greedy_stage(params, dims, xa_k, xa_v, st, suppress, blank, o, stage_end):
    """Greedy or sampling decode from ``st['i']`` to ``stage_end`` tokens
    (in place). At ``temperature > 0`` the next token is drawn from
    ``softmax(lp / temperature)`` with ``o['rng']``; the summed
    log-probability still reads the unscaled ``lp``."""
    eot, ts_begin, temperature = o["eot"], o["ts_begin"], o["temperature"]
    while st["i"] < stage_end and not bool(st["done"].all()):
        i = st["i"]
        lp = _filtered_logprobs(st["prev_logits"], i, st["last"], st["penult"],
                                st["max_ts"], suppress, blank, o)
        done = st["done"]
        if temperature > 0:
            drawn = torch.multinomial(torch.softmax(lp / temperature, dim=-1), 1,
                                      generator=o["rng"])[:, 0]
        else:
            drawn = lp.argmax(dim=-1)  # first max, as jnp.argmax
        next_tok = torch.where(done, eot, drawn)
        tok_lp = lp.gather(1, next_tok[:, None])[:, 0]
        st["sum_lp"] = st["sum_lp"] + torch.where(done, 0.0, tok_lp)
        st["out_tokens"][:, i] = next_tok
        st["done"] = done | (next_tok == eot)
        st["max_ts"] = torch.where((next_tok >= ts_begin) & ~done,
                                   torch.maximum(st["max_ts"], next_tok), st["max_ts"])
        st["penult"] = torch.full_like(st["last"], ts_begin) if i == 0 else st["last"]
        st["last"] = next_tok
        logits, st["cache"] = decoder_forward(params, dims, next_tok[:, None], xa_k, xa_v,
                                              st["cache"])
        st["prev_logits"] = logits[:, -1]
        st["i"] = i + 1
    return st


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _beam_prefill(params, dims, xa_k, xa_v, initial_tokens, sot_index, o, ctx0):
    """Prompt pass -> (beam loop state, no_speech_prob)."""
    bk = initial_tokens.shape[0]
    k = o["beam_size"]
    b = bk // k
    dev = initial_tokens.device
    max_new, eot = o["max_tokens"], o["eot"]

    cache = KVCache.zeros(dims, bk, params["decoder"]["tok_emb"].dtype, ctx=ctx0,
                          quant=o["kv_int8"], device=dev,
                          heads=local_heads(dims.n_text_head, params))
    logits, cache = decoder_forward(params, dims, initial_tokens, xa_k, xa_v, cache)
    no_speech_prob = torch.softmax(logits[:, sot_index], dim=-1)[:, o["no_speech"]]
    no_speech_prob = no_speech_prob.reshape(b, k)[:, 0]

    # beam 0 live, the others at -1e9 so the first expansion fans out
    beam_lp = torch.full((b, k), -1e9, dtype=torch.float32, device=dev)
    beam_lp[:, 0] = 0.0
    state = {
        "i": 0, "cache": cache,
        "out_tokens": torch.full((bk, max_new), eot, dtype=torch.int64, device=dev),
        "last": initial_tokens[:, -1].clone(),
        "penult": torch.full((bk,), o["ts_begin"], dtype=torch.int64, device=dev),
        "max_ts": torch.zeros((bk,), dtype=torch.int64, device=dev),
        "beam_lp": beam_lp.reshape(bk),
        "prev_logits": logits[:, -1],
        "fin_lp": torch.full((b, o["pool_size"]), _NEG_INF, dtype=torch.float32, device=dev),
        "fin_tok": torch.full((b, o["pool_size"], max_new), eot, dtype=torch.int64, device=dev),
        "fin_cnt": torch.zeros((b,), dtype=torch.int64, device=dev),
        # anc[b, k, p]: local beam row holding hypothesis k's K/V at
        # position p; the prompt is each row's own, so it starts as identity.
        "anc": torch.arange(k, dtype=torch.int32, device=dev)[None, :, None]
        .expand(b, k, ctx0).contiguous(),
    }
    return state, no_speech_prob


def _beam_stage(params, dims, xa_k, xa_v, st, suppress, blank, o, stage_end):
    """Live/finished-pool beam search from ``st['i']`` to ``stage_end``.

    openai-whisper's ``BeamSearchDecoder`` semantics, with patience: each
    step expands the top 2K candidates, routes EOT candidates into a
    per-window finished pool (capacity C = round(K * patience), first come
    in logprob order, never evicted), and refills the live fold with the
    top K non-EOT candidates. The search stops when every window holds C
    finished hypotheses or the budget runs out.
    """
    k = o["beam_size"]
    bk = st["last"].shape[0]
    b = bk // k
    v = dims.n_vocab
    eot, ts_begin, pool, max_new = o["eot"], o["ts_begin"], o["pool_size"], o["max_tokens"]
    dev = st["last"].device
    window_row = torch.arange(b, device=dev)[:, None] * k  # [B, 1]
    own = torch.arange(k, dtype=torch.int32, device=dev)[None, :]

    while st["i"] < stage_end and not bool((st["fin_cnt"] >= pool).all()):
        i = st["i"]
        cache = st["cache"]
        lp = _filtered_logprobs(st["prev_logits"], i, st["last"], st["penult"],
                                st["max_ts"], suppress, blank, o)
        total = (st["beam_lp"][:, None] + lp).reshape(b, k * v)
        # 2K candidates: at most K are EOT (one per source beam), so these
        # hold K live continuations plus every EOT that could pool.
        top_lp, top_idx = _top_k(total, 2 * k)
        src_beam = top_idx // v
        cand_tok = top_idx % v
        # openai's candidate scan stops after K live continuations, so an
        # EOT ranked below the K-th live candidate never pools; dead-beam
        # padding (~-1e9) never pools either.
        is_live = ((cand_tok != eot) & (top_lp > -1e8)).long()
        live_before = torch.cumsum(is_live, dim=1) - is_live
        valid_eot = (cand_tok == eot) & (top_lp > -1e8) & (live_before < k)

        # finished pool: insert EOT candidates in logprob order while the
        # pool has room; candidates that do not go in are routed to a spare
        # column that is dropped.
        rank = torch.cumsum(valid_eot.long(), dim=1) - 1
        slot = st["fin_cnt"][:, None] + rank
        slot = torch.where(valid_eot & (slot < pool), slot, pool)
        fin_lp = torch.cat([st["fin_lp"], st["fin_lp"][:, :1]], dim=1)
        fin_lp.scatter_(1, slot, top_lp)
        cand_rows = st["out_tokens"].reshape(b, k, max_new).gather(
            1, src_beam[:, :, None].expand(b, 2 * k, max_new))
        fin_tok = torch.cat([st["fin_tok"], st["fin_tok"][:, :1]], dim=1)
        fin_tok.scatter_(1, slot[:, :, None].expand(b, 2 * k, max_new), cand_rows)
        st["fin_lp"], st["fin_tok"] = fin_lp[:, :pool], fin_tok[:, :pool]
        st["fin_cnt"] = torch.clamp(st["fin_cnt"] + valid_eot.sum(dim=1), max=pool)

        # live fold: top K non-EOT candidates
        live_cand_lp = torch.where(cand_tok == eot, _NEG_INF, top_lp)
        live_lp, live_sel = _top_k(live_cand_lp, k)
        live_src = src_beam.gather(1, live_sel)
        next_tok = cand_tok.gather(1, live_sel).reshape(bk)

        flat_src = (live_src + window_row).reshape(bk)
        max_ts = st["max_ts"][flat_src]
        last = st["last"][flat_src]
        out_tokens = st["out_tokens"][flat_src]
        anc = None
        if o["ancestry"]:
            # never move the cache: permute the ancestor table and claim
            # the position about to be written for each row itself (past
            # the cache's end the last position, where decoder_forward
            # writes, as the JAX package's clamped dynamic_update_slice)
            anc = st["anc"].gather(1, live_src[:, :, None].expand_as(st["anc"]))
            anc[:, :, min(cache.pos, anc.shape[-1] - 1)] = own
            st["anc"] = anc
        else:
            # physical reorder of the whole cache (the A/B reference path)
            cache.k, cache.v = cache.k[:, flat_src], cache.v[:, flat_src]
            if cache.k_scale is not None:
                cache.k_scale = cache.k_scale[:, flat_src]
                cache.v_scale = cache.v_scale[:, flat_src]

        st["beam_lp"] = live_lp.reshape(bk)
        out_tokens[:, i] = next_tok
        st["out_tokens"] = out_tokens
        st["max_ts"] = torch.where(next_tok >= ts_begin, torch.maximum(max_ts, next_tok), max_ts)
        st["penult"] = torch.full_like(last, ts_begin) if i == 0 else last
        st["last"] = next_tok
        logits, st["cache"] = decoder_forward(params, dims, next_tok[:, None], xa_k, xa_v,
                                              cache, anc=anc)
        st["prev_logits"] = logits[:, -1]
        st["i"] = i + 1
    return st


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def build_initial_tokens(tokenizer: WhisperTokenizer, opts: DecodeOptions
                         ) -> Tuple[List[int], int]:
    """Conditioning sequence ([prev-prompt] + SOT block) and SOT position."""
    sot_seq = tokenizer.sot_sequence(opts.language, opts.task, opts.timestamps)
    prefix = list(opts.prompt_tokens)
    if prefix:
        prefix = [tokenizer.sot_prev] + prefix
    initial = prefix + sot_seq
    return initial, len(initial) - len(sot_seq)


def _decode_pending(params, dims, tokenizer, mel, opts, rng=None, audio_kv=None
                    ) -> Dict[str, Any]:
    """Encode + decode one batch; returns device tensors for finalize_decode."""
    xa_k, xa_v = audio_kv if audio_kv is not None else encode_audio_kv(params, dims, mel)
    b = (xa_k[0] if isinstance(xa_k, tuple) else xa_k).shape[1]
    dev = (xa_k[0] if isinstance(xa_k, tuple) else xa_k).device
    if opts.kv_int8 and not isinstance(xa_k, tuple):
        xa_k, xa_v = _quantize_cross_kv(xa_k, xa_v)

    initial, sot_index = build_initial_tokens(tokenizer, opts)
    suppress, blank = _build_filter_tables(tokenizer, opts, dims.n_vocab, dev)
    o = {
        "max_tokens": opts.max_tokens,
        "eot": tokenizer.eot,
        "ts_begin": tokenizer.timestamp_begin,
        "no_speech": tokenizer.no_speech,
        "timestamps": opts.timestamps,
        "suppress_blank": opts.suppress_blank,
        "max_initial_ts_tok": tokenizer.timestamp_begin
        + int(round(opts.max_initial_timestamp / 0.02)),
        "beam_size": opts.beam_size,
        # round(k * patience) < k is allowed (ends the search early); the
        # pool holds at least one hypothesis
        "pool_size": max(1, int(round(opts.beam_size * (opts.patience or 1.0)))),
        "kv_int8": opts.kv_int8,
        "ancestry": opts.ancestry,
        "temperature": float(opts.temperature),
    }
    beam = opts.beam_size > 1 and opts.temperature == 0.0  # sampling is per window, no beams
    if opts.temperature > 0:
        o["rng"] = rng if rng is not None else torch.Generator(device=dev).manual_seed(0)
    stages = _stage_bounds(len(initial), opts.max_tokens, dims.n_text_ctx)
    rows = b * opts.beam_size if beam else b
    init = torch.tensor(initial, dtype=torch.int64, device=dev)[None].expand(rows, -1)
    prefill, stage = (_beam_prefill, _beam_stage) if beam else (_greedy_prefill, _greedy_stage)
    st, ns_prob = prefill(params, dims, xa_k, xa_v, init, sot_index, o, stages[0][1])
    for stage_end, ctx in stages:
        st["cache"] = _pad_cache(st["cache"], ctx)
        if beam and st["anc"].shape[-1] != ctx:
            # padded slots are masked by position until written
            st["anc"] = F.pad(st["anc"], (0, ctx - st["anc"].shape[-1]))
        st = stage(params, dims, xa_k, xa_v, st, suppress, blank, o, stage_end)
    # the device checksums of what finalize_decode fetches, in the JAX
    # package's order (runtime/integrity.py)
    if beam:
        chk = checksum_device((st["out_tokens"], st["beam_lp"], st["fin_tok"], st["fin_lp"],
                               ns_prob))
        return {"tokens": st["out_tokens"], "sum_lp": st["beam_lp"], "ns_prob": ns_prob,
                "fin_tok": st["fin_tok"], "fin_lp": st["fin_lp"], "chk": chk, "beam": True,
                "b": b, "k": opts.beam_size, "eot": tokenizer.eot,
                "length_penalty": opts.length_penalty}
    chk = checksum_device((st["out_tokens"], st["sum_lp"], ns_prob))
    return {"tokens": st["out_tokens"], "sum_lp": st["sum_lp"], "ns_prob": ns_prob, "chk": chk,
            "beam": False, "b": b, "eot": tokenizer.eot}


def finalize_decode(pending: Dict[str, Any]) -> DecodeResult:
    """Host side of a decode: the verified fetch of the decode's buffers
    (against the checksums ``chk`` computed on the device; a pending dict
    without ``chk`` is fetched as it is), beam selection and per-window
    stats."""
    b, eot = pending["b"], pending["eot"]
    names = (("tokens", "sum_lp", "fin_tok", "fin_lp", "ns_prob") if pending["beam"]
             else ("tokens", "sum_lp", "ns_prob"))
    if pending.get("chk") is not None:
        hosts = fetch_verified_many([pending[n] for n in names], pending["chk"], names)
    else:
        hosts = [pending[n].cpu().numpy() for n in names]
    host = dict(zip(names, hosts))
    tokens = host["tokens"].astype(np.int32)
    sum_lp = host["sum_lp"].astype(np.float32)
    ns_prob = host["ns_prob"].astype(np.float32)
    if pending["beam"]:
        k = pending["k"]
        live_tok = tokens.reshape(b, k, -1)
        live_lp = sum_lp.reshape(b, k)
        fin_tok = host["fin_tok"].astype(np.int32)  # [B, C, T]
        fin_lp = host["fin_lp"]  # [B, C]
        penalty = pending.get("length_penalty")

        def _norm(lp, lens):
            if penalty is not None:
                # Google NMT penalty ((5 + len) / 6) ** alpha
                return lp / ((5.0 + np.maximum(lens, 1)) / 6.0) ** penalty
            return lp / np.maximum(lens, 1)  # whisper default: length norm

        t_len = live_tok.shape[-1]
        tokens = np.empty((b, t_len), np.int32)
        sum_lp = np.empty((b,), np.float32)
        for bi in range(b):
            # finished hypotheses first; top up from the live fold in raw
            # logprob order when fewer than beam_size finished
            valid = fin_lp[bi] > -1e8
            cand_t, cand_l = [fin_tok[bi][valid]], [fin_lp[bi][valid]]
            n_fin = int(valid.sum())
            if n_fin < k:
                order = np.argsort(-live_lp[bi])[: k - n_fin]
                cand_t.append(live_tok[bi][order])
                cand_l.append(live_lp[bi][order])
            ct = np.concatenate(cand_t)
            cl = np.concatenate(cand_l)
            best = int(_norm(cl, (ct != eot).sum(axis=-1)).argmax())
            tokens[bi] = ct[best]
            sum_lp[bi] = cl[best]

    lengths = (tokens != eot).sum(axis=-1).astype(np.int64)
    avg = sum_lp / np.maximum(lengths + 1, 1)  # +1 for EOT, as whisper does
    return DecodeResult(
        tokens=tokens.astype(np.int32),
        lengths=lengths,
        sum_logprobs=sum_lp.astype(np.float32),
        avg_logprobs=avg.astype(np.float32),
        no_speech_probs=ns_prob.astype(np.float32),
    )


def decode_windows(params, dims: WhisperDims, tokenizer: WhisperTokenizer,
                   mel: Optional[torch.Tensor], opts: DecodeOptions,
                   rng: Optional[torch.Generator] = None,
                   audio_kv: Optional[Tuple[Any, Any]] = None) -> DecodeResult:
    """Encode + decode one batch of 30 s mel windows. ``rng`` (a generator
    on the tensors' device; seed 0 when omitted) feeds the sampling at
    ``opts.temperature > 0``; ``audio_kv`` reuses an
    :func:`encode_audio_kv` result instead of encoding ``mel``."""
    return finalize_decode(_decode_pending(params, dims, tokenizer, mel, opts, rng, audio_kv))


def detect_language(params, dims: WhisperDims, tokenizer: WhisperTokenizer,
                    mel: torch.Tensor) -> Tuple[str, Dict[str, float]]:
    """Single-step language ID: the distribution over the language tokens
    after SOT, averaged over the batch ``mel [B, n_mels, 3000]``.
    Returns ``(language_code, {code: probability})``."""
    xa_k, xa_v = encode_audio_kv(params, dims, mel)
    b = mel.shape[0]
    sot = torch.full((b, 1), tokenizer.sot, dtype=torch.int64, device=mel.device)
    cache = KVCache.zeros(dims, b, params["decoder"]["tok_emb"].dtype, ctx=8, device=mel.device,
                          heads=local_heads(dims.n_text_head, params))
    logits, _ = decoder_forward(params, dims, sot, xa_k, xa_v, cache)
    n_lang = tokenizer.special.n_languages
    start = tokenizer.special.language_start
    probs = torch.softmax(logits[:, 0, start : start + n_lang].float(), dim=-1)
    probs = probs.cpu().numpy().mean(axis=0)
    best = int(np.argmax(probs))
    return LANGUAGES[best], {LANGUAGES[i]: float(probs[i]) for i in range(n_lang)}

"""Faults planted in the program, which the check must catch: the CPU tests
plant them at a small size, and ``control.py --faults`` at the cell's own
size on the card.

A serving fault is ``plant(probe, pipe)``: it wraps a module attribute of
the port through ``probe.patch``, so the probe restores it after the run.
A training fault wraps the program's train step.
"""

from __future__ import annotations

import numpy as np
import torch


def token_altered(probe, pipe) -> None:
    """The sixth served token of every window, one id further."""
    from modular_audio_pipeline_tpu_torch.models.whisper import decode as dec_mod

    eot = pipe.backend.tokenizer.eot

    def make(orig):
        def finalize(pending):
            res = orig(pending)
            res.tokens[:, 5] = np.where(res.tokens[:, 5] + 1 == eot, 0, res.tokens[:, 5] + 1)
            return res
        return finalize

    probe.patch(dec_mod, "finalize_decode", make)


def half_batch(probe, pipe) -> None:
    """Each decode batch decodes its first half of rows only."""
    from modular_audio_pipeline_tpu_torch.models.whisper import decode as dec_mod

    def make(orig):
        def pending(params, dims, tok, mel, opts, rng=None, audio_kv=None):
            h = mel.shape[0] // 2
            kv = None if audio_kv is None else tuple(x[:, :h] for x in audio_kv)
            return orig(params, dims, tok, mel[:h], opts, rng, kv)
        return pending

    probe.patch(dec_mod, "_decode_pending", make)


def state_unchanged(probe, pipe) -> None:
    """Each decode step leaves the self-attention cache as it found it."""
    from modular_audio_pipeline_tpu_torch.models.whisper import decode as dec_mod
    from modular_audio_pipeline_tpu_torch.models.whisper.model import KVCache

    def copy(x):
        return None if x is None else x.clone()

    def make(orig):
        def forward(params, dims, tokens, xk, xv, cache, *a, **kw):
            if tokens.shape[1] != 1:
                return orig(params, dims, tokens, xk, xv, cache, *a, **kw)
            shadow = KVCache(copy(cache.k), copy(cache.v), cache.pos, copy(cache.k_scale),
                             copy(cache.v_scale))
            logits, shadow = orig(params, dims, tokens, xk, xv, shadow, *a, **kw)
            cache.pos = shadow.pos
            return logits, cache
        return forward

    probe.patch(dec_mod, "decoder_forward", make)


def keep_shifted(probe, pipe) -> None:
    """The VAD's speech stamps, 250 ms late."""
    from modular_audio_pipeline_tpu_torch.models import vad_net

    def make(orig):
        def stamps(*a, **kw):
            return [dict(s, start=s["start"] + 0.25, end=s["end"] + 0.25)
                    for s in orig(*a, **kw)]
        return stamps

    probe.patch(vad_net, "speech_timestamps_from_probs", make)


def labels_altered(probe, pipe) -> None:
    """Every other subsegment's speaker label, the next label."""
    from modular_audio_pipeline_tpu_torch.models.diarization import clustering

    def make(orig):
        def cluster(*a, **kw):
            labels = np.array(orig(*a, **kw))
            k = max(2, int(labels.max()) + 1)
            labels[::2] = (labels[::2] + 1) % k
            return labels
        return cluster

    probe.patch(clustering, "cluster_embeddings", make)


def segmentation_attention_zeroed(probe, pipe) -> None:
    """The diarization's segmentation network gets zeros from its attention."""
    from modular_audio_pipeline_tpu_torch.models.diarization import segmentation

    def make(orig):
        def attention(q, k, v):
            return torch.zeros_like(orig(q, k, v))
        return attention

    probe.patch(segmentation, "flash_attention", make)


SERVE = {f.__name__: f for f in (token_altered, half_batch, state_unchanged, keep_shifted,
                                 labels_altered, segmentation_attention_zeroed)}


def train_half_batch(train_step):
    """The loss over the first half of each batch."""
    def step(state, mel, tokens, targets):
        h = mel.shape[0] // 2
        return train_step(state, mel[:h], tokens[:h], targets[:h])
    return step


def train_state_unchanged(train_step):
    """Each step leaves the parameters as it found them."""
    from .weights import leaves

    def step(state, mel, tokens, targets):
        before = [p.detach().clone() for _, p in leaves(state.params)]
        state, loss = train_step(state, mel, tokens, targets)
        with torch.no_grad():
            for (_, p), b in zip(leaves(state.params), before):
                p.copy_(b)
        return state, loss
    return step


TRAIN = {"half_batch": train_half_batch, "state_unchanged": train_state_unchanged}
BY_KIND = {"serve_closed_loop": SERVE, "train_steps": TRAIN}


def plant(kind: str, name: str):
    """The fault ``name`` for a cell of the traffic kind ``kind``; a kind
    not listed here keeps its faults in its module's ``FAULTS``."""
    if kind in BY_KIND:
        return BY_KIND[kind][name]
    from .spec import kind as kind_module

    return kind_module(kind).FAULTS[name]

"""The input generator that the traffic files of the two kinds here
parameterise (``kinds/serve_closed_loop.py``, ``kinds/train_steps.py``);
a new kind may bring a generator of its own.

A recording's layout (when each utterance starts, how long it lasts, which
of four speaker slots says it, and the gaps between) comes from the
traffic file's ``layout_seed`` alone, so every ``--seed`` gives the same
layout and the program does the same amount of work. ``--seed`` picks the
voices and what they say: it draws four voices from the copied voice
model (``voices.py``) and a bank of utterances for each, and each
utterance of the layout is a bank item of its slot's voice, cut to the
layout's length with a 10 ms fade. Drawing a bank instead of every
utterance keeps set-up short: the voice model takes about 25 s of one
core for 16 minutes of speech.

Training batches use the same bank for their 30 s clips, and their label
lengths come from the layout seed; the label token ids come from
``--seed``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from .voices import sample_voice, synth_utterance

SR = 16000
FADE = 160  # samples: 10 ms
IGNORE_INDEX = -100


def layout(seconds: float, layout_seed: int, utterance_s: Tuple[float, float],
           gap_s: Tuple[float, float], lead_s: float, speakers: int
           ) -> List[Tuple[float, float, int]]:
    """[(start s, length s, speaker slot)] filling ``seconds``; the last
    utterance ends before ``seconds``."""
    rng = np.random.default_rng(layout_seed)
    out = []
    t = lead_s
    while True:
        dur = float(rng.uniform(*utterance_s))
        slot = int(rng.integers(speakers))
        if t + dur > seconds:
            break
        out.append((round(t, 4), round(dur, 4), slot))
        t += dur + float(rng.uniform(*gap_s))
    return out


def voice_bank(seed: int, speakers: int, per_voice: int, item_s: float, pause_prob: float
               ) -> List[List[np.ndarray]]:
    """``per_voice`` utterances of ``item_s`` seconds for each of
    ``speakers`` voices drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    voices = [sample_voice(rng) for _ in range(speakers)]
    return [[synth_utterance(v, item_s, rng, pause_prob=pause_prob) for _ in range(per_voice)]
            for v in voices]


def render(seconds: float, utts: List[Tuple[float, float, int]], bank, rng) -> np.ndarray:
    """The layout voiced from ``bank``: slot -> voice by a permutation from
    ``rng``, each utterance a bank item from ``rng``. float32 in [-1, 1]."""
    perm = rng.permutation(len(bank))
    out = np.zeros(int(round(seconds * SR)), dtype=np.float32)
    fade = np.linspace(1.0, 0.0, FADE, dtype=np.float32)
    for start, dur, slot in utts:
        items = bank[perm[slot]]
        utt = items[int(rng.integers(len(items)))][: int(round(dur * SR))].copy()
        utt[-FADE:] *= fade
        a = int(round(start * SR))
        out[a: a + len(utt)] = utt
    return out


def recordings(traffic: Dict[str, Any], seed: int) -> Tuple[List[np.ndarray], list]:
    """The pool of ``traffic['pool']`` int16 recordings for ``seed`` and the
    layout they share."""
    g = traffic["generator"]
    utts = layout(g["seconds"], g["layout_seed"], tuple(g["utterance_s"]), tuple(g["gap_s"]),
                  g["lead_s"], g["speakers"])
    bank = voice_bank(seed, g["speakers"], g["bank_per_voice"], g["utterance_s"][1],
                      g["pause_prob"])
    pool = []
    for r in range(g["pool"]):
        x = render(g["seconds"], utts, bank, np.random.default_rng([seed, r + 1]))
        pool.append(np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16))
    return pool, utts


def training_batches(traffic: Dict[str, Any], seed: int, vocab_text: int,
                     sot: List[int], eot: int) -> List[Dict[str, np.ndarray]]:
    """``traffic['generator']['batches']`` batches of ``batch`` 30 s clips
    (float32 audio ``[B, 480000]``) with labels: ``tokens``/``targets``
    ``[B, seq]`` as the port's ``training.data.encode_example`` lays them
    out (SOT block, text ids, EOT; targets shifted by one, the SOT block
    ignored, the pad ignored). Every row differs."""
    g = traffic["generator"]
    b, seq, n_batches = g["batch"], g["seq_len"], g["batches"]
    clip_s = g["clip_s"]
    lay_rng = np.random.default_rng(g["layout_seed"])
    clip_layouts = [layout(clip_s, int(lay_rng.integers(2**31)), tuple(g["utterance_s"]),
                           tuple(g["gap_s"]), g["lead_s"], g["speakers"])
                    for _ in range(b * n_batches)]
    text_lens = lay_rng.integers(g["text_tokens"][0], g["text_tokens"][1] + 1, b * n_batches)
    bank = voice_bank(seed, g["speakers"], g["bank_per_voice"], g["utterance_s"][1],
                      g["pause_prob"])
    rng = np.random.default_rng([seed, 0])
    out = []
    for i in range(n_batches):
        audio = np.zeros((b, int(clip_s * SR)), dtype=np.float32)
        tokens = np.full((b, seq), eot, dtype=np.int64)
        targets = np.full((b, seq), IGNORE_INDEX, dtype=np.int64)
        for j in range(b):
            k = i * b + j
            audio[j] = render(clip_s, clip_layouts[k], bank, rng)
            text = rng.integers(0, vocab_text, int(text_lens[k])).tolist()
            full = (sot + text + [eot])[: seq + 1]
            tokens[j, : len(full) - 1] = full[:-1]
            targets[j, : len(full) - 1] = full[1:]
            targets[j, : len(sot) - 1] = IGNORE_INDEX
        out.append({"audio": audio, "tokens": tokens, "targets": targets})
    return out

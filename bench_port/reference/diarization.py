"""Plain speaker turns of a flat timeline, as the program's
``SpeakerDiarizer`` defines them, from the shipped bundles' weights.

Speech regions: the segmentation network's activity (``segmentation.py``,
rounded to f16 as the program hands it on) of 10 s windows 1 s apart,
overlap-averaged onto a 10 ms grid with each window's speakers permuted
to agree best with the running average; speech where any speaker passes
0.5; gaps of up to 400 ms filled inside, islands of up to 200 ms dropped;
regions past the valid length cut. Subsegments of 1.5 s every 0.75 s
inside each region (a region shorter than 1.5 s but over 0.25 s keeps
one, ending with it), each read from the timeline's 16-sample blocks.
Embeddings: MFCCs c1..c19 of each subsegment, three ReLU convolutions
(widths 5, 3, 3, dilations 1, 2, 3), mean and population deviation over
time, a projection to 192, unit norm. Clustering: one speaker when the
90th percentile of raw cosine distances (of a fixed subsample of 1536) is
under the bundle's cut-off (only when one speaker is allowed); otherwise
average-linkage over standardised, renormalised embeddings cut at the
bundle's threshold and held to the allowed speaker counts; labels by first
appearance. Turns: neighbouring subsegments of one label merged when they
lie within 0.75 s. f32 with TF32 off, f64 on the host; it imports nothing
of the program.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.cluster.hierarchy import fcluster, linkage

from . import segmentation

SR, HOP = 16000, 160
SUBSEG, SUBSEG_HOP, BLOCK = 24000, 12000, 16


def regions(activity: np.ndarray, n: int, n_valid: int) -> List[Tuple[int, int]]:
    """Speech regions (samples) from window activity ``[windows, 1000, 3]``."""
    n_frames = n // HOP
    acc = np.zeros((n_frames, 3))
    weight = np.zeros((n_frames, 1))
    for i, acts in enumerate(activity):
        f0 = i * (SR // HOP)
        t = min(acts.shape[0], n_frames - f0)
        if t <= 0:
            continue
        seg = acts[:t]
        if weight[f0: f0 + t].sum() > 0:
            prev = acc[f0: f0 + t] / np.maximum(weight[f0: f0 + t], 1e-9)
            best = max(itertools.permutations(range(3)),
                       key=lambda p: float((prev * seg[:, p]).sum()))
            seg = seg[:, best]
        acc[f0: f0 + t] += seg
        weight[f0: f0 + t] += 1.0
    speech = (acc / np.maximum(weight, 1e-9)).astype(np.float32).max(axis=-1) > 0.5
    for value, longest in ((False, 40), (True, 20)):
        edges = np.flatnonzero(np.diff(speech.astype(np.int8)))
        for s, e in zip(np.concatenate([[0], edges + 1]), np.concatenate([edges, [n_frames - 1]])):
            if speech[s] == value and e - s + 1 <= longest:
                if not value and (s == 0 or e == n_frames - 1):
                    continue
                speech[s: e + 1] = not value
    idx = np.flatnonzero(speech)
    if idx.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    out = [(int(idx[s]) * HOP, min(n, (int(idx[e]) + 1) * HOP))
           for s, e in zip(np.concatenate([[0], breaks + 1]), np.concatenate([breaks, [idx.size - 1]]))]
    return [(s, min(e, n_valid)) for s, e in out if s < n_valid]


def subsegments(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for a, b in spans:
        pos = a
        while pos + SUBSEG <= b:
            out.append((pos, pos + SUBSEG))
            pos += SUBSEG_HOP
        if SR // 4 < b - a < SUBSEG:
            out.append((max(0, b - SUBSEG), max(0, b - SUBSEG) + SUBSEG))
    return out


@torch.no_grad()
def embed(timeline: torch.Tensor, subs: List[Tuple[int, int]], p: Dict[str, torch.Tensor],
          block: int = 512) -> np.ndarray:
    n_blocks = timeline.shape[0] // BLOCK
    starts = [min(s // BLOCK, max(0, n_blocks - SUBSEG // BLOCK)) * BLOCK for s, _ in subs]
    out = []
    for lo in range(0, len(starts), block):
        audio = torch.stack([timeline[s: s + SUBSEG] for s in starts[lo: lo + block]])
        x = segmentation.mfcc(audio, n=20)[..., 1:].transpose(1, 2)
        for name, dil in (("conv1", 1), ("conv2", 2), ("conv3", 3)):
            w = p[f"{name}/w"]
            x = F.relu(F.conv1d(x, w, p[f"{name}/b"], padding=(w.shape[2] - 1) * dil // 2,
                                dilation=dil))
        e = torch.cat([x.mean(dim=-1), x.std(dim=-1, correction=0)], dim=-1) @ p["proj/w"]
        e = e + p["proj/b"]
        out.append((e / e.norm(dim=-1, keepdim=True).clamp(min=1e-8)).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 192), np.float32)


def _cosine(x: np.ndarray) -> np.ndarray:
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    i, j = np.triu_indices(len(x), k=1)
    return np.clip(1.0 - (xn @ xn.T)[i, j], 0.0, 2.0)


def cluster(emb: np.ndarray, lo: int, hi: int, threshold: float, single: float) -> np.ndarray:
    n = len(emb)
    if n <= 1 or hi <= 1:
        return np.zeros(n, dtype=np.int64)
    if lo <= 1:
        sub = emb[np.random.default_rng(0).choice(n, 1536, False)] if n > 1536 else emb
        if np.percentile(_cosine(sub.astype(np.float64)), 90) < single:
            return np.zeros(n, dtype=np.int64)
    x = emb.astype(np.float64)
    x = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-8)
    z = linkage(_cosine(x), method="average")
    labels = fcluster(z, t=threshold, criterion="distance")
    k = len(np.unique(labels))
    lo, hi = max(1, lo), max(max(1, lo), hi)
    if k < lo:
        labels = fcluster(z, t=min(lo, n), criterion="maxclust")
    elif k > hi:
        labels = fcluster(z, t=hi, criterion="maxclust")
    first = {}
    return np.array([first.setdefault(v, len(first)) for v in labels], dtype=np.int64)


def turns(subs: List[Tuple[int, int]], labels) -> List[Dict]:
    out: List[Dict] = []
    for (s, e), lab in zip(subs, labels):
        t0, t1 = s / SR, e / SR
        if out and out[-1]["label"] == int(lab) and t0 <= out[-1]["end"] + SUBSEG_HOP / SR:
            out[-1]["end"] = max(out[-1]["end"], t1)
        else:
            out.append({"label": int(lab), "start": t0, "end": t1})
    return [{"speaker": f"S{t['label']}", "start": round(t["start"], 3),
             "end": round(t["end"], 3)} for t in out]


def diarize(timeline: torch.Tensor, activity: torch.Tensor, n_valid: int, bundles: Path,
            min_speakers: int, max_speakers: int) -> List[Dict]:
    """Turns (seconds of the timeline) of ``timeline [N]`` f32, valid up to
    ``n_valid`` samples, from its segmentation ``activity``
    (``segmentation.window_activity``) and the bundles under ``bundles``."""
    dev = timeline.device
    spans = regions(activity.half().float().cpu().numpy(), int(timeline.shape[0]), n_valid)
    subs = subsegments(spans)
    if not subs:
        return []
    emb_dir = bundles / "diarization-embedding"
    emb = embed(timeline, subs, segmentation.load(emb_dir / "params.npz", dev))
    cal = json.loads((emb_dir / "calibration.json").read_text())
    labels = cluster(emb, min_speakers, max_speakers, cal["ahc_threshold"],
                     cal["single_speaker_cutoff"])
    return turns(subs, labels)

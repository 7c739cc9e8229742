"""Training recipes for the learned diarization stack (PyTorch, zero-egress).

Counterpart of ``modular_audio_pipeline_tpu/training/diarization.py``. The
synthetic voices, scenes and conversations are host numpy, copied: the
same seed gives the same data. On the card unless the caller asks for the
CPU:

- :func:`train_embedder`: additive-angular-margin softmax over a seeded
  population of synthetic speakers; the classifier head is discarded and
  the 192-d unit-norm embedding trunk (:class:`~..models.diarization.
  embedding.ConvEmbedder`) saved.
- :func:`train_segmentation`: permutation-invariant powerset
  cross-entropy on synthetic overlapping scenes for
  :class:`~..models.diarization.segmentation.SegmentationNet`, whose
  self-attention is the flash kernel (f32, head dim 32) with its recompute
  backward.
- :func:`calibrate_threshold` and :func:`calibrate_single_cutoff`: the
  AHC cut distance and the single-speaker cutoff on held-out synthetic
  conversations, written to ``calibration.json`` beside the embedder.

Run offline::

    python -m modular_audio_pipeline_tpu_torch.training.diarization \
        --out ~/.cache/map_tpu --steps 600
"""

from __future__ import annotations

import json
import logging
import tempfile
import time
from itertools import permutations
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .voices import SR, sample_voice, synth_conversation, synth_utterance

logger = logging.getLogger(__name__)

__all__ = [
    "train_embedder",
    "train_segmentation",
    "calibrate_threshold",
    "calibrate_single_cutoff",
    "evaluate_der",
    "main",
]

_SUBSEG = int(1.5 * SR)  # embedder input: 1.5 s, matching diarizer spans


# --------------------------------------------------------------------------
# Embedder: AAM-softmax speaker classification
# --------------------------------------------------------------------------


def _speaker_pool(n_speakers: int, seed: int):
    rng = np.random.default_rng(seed)
    return [sample_voice(rng) for _ in range(n_speakers)], rng


def _embedder_batch(
    voices, rng: np.random.Generator, batch_speakers: int, utts: int,
    augment: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Augmentation mirrors the deployment corruptions: additive noise
    (held-out benchmark uses up to 0.008), random gain, and a low-level
    interfering background speaker (overlapped-speech robustness)."""
    spk_ids = rng.choice(len(voices), size=batch_speakers, replace=False)
    audio = np.zeros((batch_speakers * utts, _SUBSEG), dtype=np.float32)
    labels = np.zeros(batch_speakers * utts, dtype=np.int32)
    i = 0
    for s in spk_ids:
        for _ in range(utts):
            x = synth_utterance(voices[s], 1.5, rng, pause_prob=0.1)
            if augment:
                x = x * rng.uniform(0.4, 1.4)
                if rng.random() < 0.3:  # background speaker at -12..-6 dB
                    other = int(rng.integers(len(voices)))
                    if other != s:
                        bg = synth_utterance(voices[other], 1.5, rng)
                        x = x + rng.uniform(0.25, 0.5) * bg[: len(x)]
                x = x + rng.uniform(0.0, 0.012) * rng.standard_normal(
                    len(x)
                ).astype(np.float32)
            audio[i] = x[:_SUBSEG]
            labels[i] = s
            i += 1
    return audio, labels


def train_embedder(
    out_dir: str,
    n_speakers: int = 192,
    steps: int = 1200,
    batch_speakers: int = 16,
    utts_per_speaker: int = 4,
    lr: float = 1e-3,
    margin: float = 0.3,
    scale: float = 30.0,
    seed: int = 0,
    params=None,
    device=None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Dict[str, float]:
    """Train ConvEmbedder with additive-angular-margin softmax; save to
    ``out_dir/params.npz``. Returns final train metrics.

    ``params``: ``{"net": trunk, "cls": [192, n_speakers]}`` in the JAX
    layout, or the trunk alone (numpy or a bundle dir) with the classifier
    drawn from ``seed + 1``; None draws both from seeded
    ``torch.Generator``s. ``on_step(i, loss)`` sees each step's loss."""
    import torch.nn.functional as F

    from ..models.diarization.embedding import ConvEmbedder
    from ..models.vad_net import no_tf32
    from ..models.whisper.convert import initial_params, save_params
    from ..utils import resolve_device
    from .optim import adam, cosine_decay_schedule, softmax_cross_entropy

    dev = resolve_device(device)
    voices, rng = _speaker_pool(n_speakers, seed)
    trunk = params.get("net") if isinstance(params, dict) and "net" in params else params
    net = ConvEmbedder(initial_params(trunk, ConvEmbedder.init_params, seed), device=dev)
    net.requires_grad_(True)
    if isinstance(params, dict) and "cls" in params:
        cls_w = torch.tensor(np.asarray(params["cls"], np.float32))
    else:
        g = torch.Generator().manual_seed(seed + 1)
        cls_w = torch.randn((ConvEmbedder.OUT, n_speakers), generator=g) * 0.05
    cls_w = cls_w.to(dev).requires_grad_(True)
    state = adam(cosine_decay_schedule(lr, steps)).init(list(net.parameters()) + [cls_w])

    t0 = time.time()
    loss = acc = 0.0
    for i in range(steps):
        audio, labels = _embedder_batch(voices, rng, batch_speakers, utts_per_speaker)
        audio_t = torch.from_numpy(audio).to(dev)
        labels_t = torch.from_numpy(labels).long().to(dev)
        with no_tf32():
            emb = net(audio_t)  # [B, 192] unit-norm
            w = cls_w / torch.clamp(torch.linalg.vector_norm(cls_w, dim=0, keepdim=True),
                                    min=1e-8)
            cos = emb @ w  # [B, S]
            theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
            onehot = F.one_hot(labels_t, w.shape[1]).float()
            logits = scale * torch.where(onehot > 0, torch.cos(theta + margin), cos)
            loss_d = softmax_cross_entropy(logits, onehot).mean()
            state.zero_grad()
            loss_d.backward()
        state.step()
        if on_step is not None:
            on_step(i, loss_d.detach())
        if i % 50 == 0 or i == steps - 1:
            acc_d = (torch.argmax(cos, dim=-1) == labels_t).float().mean()
            loss, acc = float(loss_d.detach()), float(acc_d)
            logger.info("embedder step %d/%d loss=%.4f acc=%.3f (%.1fs)",
                        i, steps, loss, acc, time.time() - t0)

    save_params(net.numpy_params(), out_dir)
    logger.info("Saved embedder checkpoint to %s", out_dir)
    return {"loss": loss, "train_acc": acc, "steps": steps}


# --------------------------------------------------------------------------
# Segmentation: permutation-invariant powerset training
# --------------------------------------------------------------------------

_SCENE_S = 10.0
_HOP = SR // 100  # 10 ms label grid, matching the MFCC frontend
_PERMS = list(permutations(range(3)))
# activity triple (a, b, c) -> powerset class id
_CLASS_OF = {
    (0, 0, 0): 0, (1, 0, 0): 1, (0, 1, 0): 2, (0, 0, 1): 3,
    (1, 1, 0): 4, (1, 0, 1): 5, (0, 1, 1): 6,
}


def _synth_scene(
    rng: np.random.Generator, n_frames: int
) -> Tuple[np.ndarray, np.ndarray]:
    """One 10 s scene -> (mix [n], activity [n_frames, 3]).

    1-3 speakers each place 1-3 utterances at random starts; frame labels
    come from per-speaker track energy (so intra-utterance pauses are
    labelled silent, like real annotation)."""
    n = int(_SCENE_S * SR)
    n_spk = int(rng.integers(1, 4))
    tracks = np.zeros((3, n), dtype=np.float32)
    for s in range(n_spk):
        voice = sample_voice(rng)
        for _ in range(int(rng.integers(1, 4))):
            dur = float(rng.uniform(1.0, 4.0))
            start = int(rng.uniform(0.0, max(0.1, _SCENE_S - dur)) * SR)
            utt = synth_utterance(voice, dur, rng)
            tracks[s, start : start + len(utt)] += utt

    mix = tracks.sum(axis=0)
    if rng.random() < 0.5:
        mix = mix + rng.uniform(0.001, 0.01) * rng.standard_normal(n).astype(
            np.float32
        )
    peak = np.abs(mix).max()
    if peak > 0.95:
        mix = mix / peak * 0.95

    # frame activity from track energy on the 10 ms grid
    usable = (n // _HOP) * _HOP
    frame_rms = np.sqrt(
        (tracks[:, :usable] ** 2).reshape(3, -1, _HOP).mean(axis=-1)
    )  # [3, n//hop]
    act = (frame_rms > 0.01).astype(np.int32).T  # [n_frames_raw, 3]
    # trim/pad to the MFCC frame count
    if act.shape[0] >= n_frames:
        act = act[:n_frames]
    else:
        act = np.pad(act, ((0, n_frames - act.shape[0]), (0, 0)))
    # powerset covers <=2 simultaneous speakers: drop the weakest third
    over = act.sum(axis=1) > 2
    if over.any():
        rms_t = frame_rms.T[:n_frames]
        rms_t = np.pad(rms_t, ((0, act.shape[0] - rms_t.shape[0]), (0, 0)))
        weakest = np.argmin(np.where(act > 0, rms_t, np.inf), axis=1)
        act[over, weakest[over]] = 0
    return mix.astype(np.float32), act


def _perm_class_labels(act: np.ndarray) -> np.ndarray:
    """activity [T, 3] -> class labels per permutation [6, T]."""
    out = np.zeros((len(_PERMS), act.shape[0]), dtype=np.int32)
    for pi, perm in enumerate(_PERMS):
        permuted = act[:, list(perm)]
        out[pi] = [_CLASS_OF[tuple(row)] for row in permuted]
    return out


def train_segmentation(
    out_dir: str,
    steps: int = 400,
    batch: int = 8,
    lr: float = 8e-4,
    seed: int = 0,
    params=None,
    device=None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Dict[str, float]:
    """Train SegmentationNet with permutation-invariant powerset CE; save
    to ``out_dir/params.npz``.

    ``params``: the initial parameters (numpy in the JAX layout, or a bundle
    dir); None draws them from ``seed``. ``on_step(i, loss)`` sees each
    step's loss tensor."""
    from ..models.diarization.features import mfcc_batch
    from ..models.diarization.segmentation import SegmentationNet
    from ..models.whisper.convert import initial_params, save_params
    from ..utils import resolve_device
    from .optim import adam, cosine_decay_schedule

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    net = SegmentationNet(initial_params(params, SegmentationNet.init_params, seed), device=dev)
    net.requires_grad_(True)

    # frame count of the MFCC frontend for a 10 s scene
    n = int(_SCENE_S * SR)
    n_frames = (n - int(SR * 0.025)) // _HOP + 1
    state = adam(cosine_decay_schedule(lr, steps)).init(net.parameters())

    t0 = time.time()
    loss = acc = 0.0
    for i in range(steps):
        mixes = np.zeros((batch, n), dtype=np.float32)
        labels = np.zeros((batch, len(_PERMS), n_frames), dtype=np.int32)
        for b in range(batch):
            mix, act = _synth_scene(rng, n_frames)
            mixes[b, : len(mix)] = mix[:n]
            labels[b] = _perm_class_labels(act)
        mel = mfcc_batch(torch.from_numpy(mixes).to(dev), sr=SR, n_mfcc=40, n_mels=40)
        perm_labels = torch.from_numpy(labels).long().to(dev)

        logits = net(mel)  # [B, T, 7]
        logp = torch.log_softmax(logits, dim=-1)
        # CE per permutation: the target log-probabilities [B, 6, T]
        gathered = torch.gather(logp[:, None].expand(-1, len(_PERMS), -1, -1), -1,
                                perm_labels[..., None])[..., 0]
        ce = -gathered.mean(dim=-1)  # [B, 6]
        loss_d = ce.min(dim=-1).values.mean()  # PIT: the best permutation per scene
        state.zero_grad()
        loss_d.backward()
        state.step()
        if on_step is not None:
            on_step(i, loss_d.detach())
        if i % 50 == 0 or i == steps - 1:
            best = ce.argmin(dim=-1)
            target = torch.gather(perm_labels, 1,
                                  best[:, None, None].expand(-1, 1, n_frames))[:, 0]
            acc_d = (logits.argmax(-1) == target).float().mean()
            loss, acc = float(loss_d.detach()), float(acc_d)
            logger.info("segmentation step %d/%d loss=%.4f frame_acc=%.3f (%.1fs)",
                        i, steps, loss, acc, time.time() - t0)

    save_params(net.numpy_params(), out_dir)
    logger.info("Saved segmentation checkpoint to %s", out_dir)
    return {"loss": loss, "frame_acc": acc, "steps": steps}


# --------------------------------------------------------------------------
# Threshold calibration + DER evaluation on held-out synthetic speech
# --------------------------------------------------------------------------


def _held_out_conversations(seed: int, count: int = 12):
    """Conversations from voices OUTSIDE the training pool (seed offset),
    1-4 speakers, overlap + noise — the 'hard' synthetic benchmark."""
    rng = np.random.default_rng(seed + 10_000)
    convs = []
    for c in range(count):
        n_spk = int(rng.integers(1, 5))
        voices = [sample_voice(rng) for _ in range(n_spk)]
        n_turns = int(rng.integers(4, 9))
        turns = [
            (int(rng.integers(0, n_spk)), float(rng.uniform(2.0, 5.0)))
            for _ in range(n_turns)
        ]
        audio, truth = synth_conversation(
            voices, turns, rng,
            overlap_prob=0.3, max_overlap_s=1.0,
            noise_level=float(rng.uniform(0.0, 0.008)),
        )
        convs.append((audio, truth, n_spk))
    return convs


def evaluate_der(diarizer, tmp_dir: str, seed: int = 0, count: int = 12) -> float:
    """Mean DER of ``diarizer`` over the held-out synthetic benchmark."""
    from ..audio_io import write_wav
    from ..evaluation import der

    Path(tmp_dir).mkdir(parents=True, exist_ok=True)
    total = 0.0
    for i, (audio, truth, n_spk) in enumerate(_held_out_conversations(seed, count)):
        path = str(Path(tmp_dir) / f"cal_{i}.wav")
        write_wav(path, audio, SR)
        hyp = [(s.speaker, s.start, s.end) for s in diarizer.diarize(path, 1, 5)]
        total += der(truth, hyp)["der"]
    return total / count


def calibrate_single_cutoff(
    weights_dir: str, seed: int = 0, count: int = 6, device=None,
) -> float:
    """Calibrate the single-speaker homogeneity cutoff for the trained
    embedder: the 90th-percentile cosine distance separates single-speaker
    recordings from two-speaker ones; a point in the gap, biased toward
    "multi", goes into ``calibration.json``."""
    from scipy.spatial.distance import pdist

    from ..diarizer import SpeakerDiarizer

    diar = SpeakerDiarizer(weights_path=weights_dir, lazy_load=True, device=device)
    diar.load_model()
    rng = np.random.default_rng(seed + 20_000)

    def p90(n_spk: int) -> List[float]:
        vals = []
        for _ in range(count):
            voices = [sample_voice(rng) for _ in range(n_spk)]
            turns = [(int(rng.integers(0, n_spk)), float(rng.uniform(2.0, 5.0)))
                     for _ in range(6)]
            audio, _truth = synth_conversation(
                voices, turns, rng, noise_level=float(rng.uniform(0.0, 0.008)))
            spans = diar._subsegments(audio, SR)
            if len(spans) < 3:
                continue
            emb = diar._embed_all(audio, SR, spans)
            d = pdist(emb.astype(np.float64), metric="cosine")
            vals.append(float(np.percentile(d, 90)))
        return vals

    single_hi = max(p90(1) or [0.05])
    multi_lo = min(p90(2) or [0.15])
    if multi_lo > single_hi:
        # 25% of the way up the gap: a false "single" verdict merges all
        # speakers, a false "multi" only splits one voice
        cutoff = single_hi + 0.25 * (multi_lo - single_hi)
    else:  # the distributions overlap: stay just above single
        cutoff = single_hi * 1.05
    cutoff = float(np.clip(cutoff, 0.03, 0.4))
    logger.info("single-speaker cutoff: p90(1spk) max=%.3f, p90(2spk) min=%.3f -> %.3f",
                single_hi, multi_lo, cutoff)

    cal_path = Path(weights_dir) / "calibration.json"
    cal = json.loads(cal_path.read_text()) if cal_path.exists() else {}
    cal["single_speaker_cutoff"] = round(cutoff, 4)
    cal_path.write_text(json.dumps(cal, indent=2))
    return cutoff


def calibrate_threshold(
    weights_dir: str,
    thresholds: Optional[List[float]] = None,
    seed: int = 0,
    tmp_dir: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """Sweep the AHC cut distance with the trained embedder on held-out
    conversations (two disjoint seed streams); write the best to
    ``weights_dir/calibration.json``."""
    from ..diarizer import SpeakerDiarizer

    tmp_dir = tmp_dir or str(Path(tempfile.gettempdir()) / "map_tpu_calib")
    thresholds = thresholds or [0.85, 1.0, 1.1, 1.2, 1.3, 1.45]
    best_t, best_der = None, float("inf")
    for t in thresholds:
        diar = SpeakerDiarizer(weights_path=weights_dir, lazy_load=True, device=device)
        diar.ahc_threshold = t
        mean_der = 0.5 * (evaluate_der(diar, tmp_dir, seed=seed)
                          + evaluate_der(diar, tmp_dir, seed=seed + 500))
        logger.info("AHC threshold %.2f -> DER %.3f", t, mean_der)
        if mean_der < best_der:
            best_t, best_der = t, mean_der

    cal_path = Path(weights_dir) / "calibration.json"
    out = json.loads(cal_path.read_text()) if cal_path.exists() else {}
    out.update(ahc_threshold=best_t, held_out_der=round(best_der, 4))
    cal_path.write_text(json.dumps(out, indent=2))
    logger.info("Calibration saved: %s", out)
    return out


def main(argv: Optional[List[str]] = None, device=None) -> None:
    import argparse
    import os

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.environ.get(
        "MAP_TPU_WEIGHTS", os.path.join(os.path.expanduser("~"), ".cache", "map_tpu")))
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seg-steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-embedder", action="store_true")
    ap.add_argument("--skip-segmentation", action="store_true")
    ap.add_argument("--skip-calibration", action="store_true")
    args = ap.parse_args(argv)

    emb_dir = os.path.join(args.out, "diarization-embedding")
    seg_dir = os.path.join(args.out, "diarization-segmentation")
    if not args.skip_embedder:
        train_embedder(emb_dir, steps=args.steps, seed=args.seed, device=device)
    if not args.skip_segmentation:
        train_segmentation(seg_dir, steps=args.seg_steps, seed=args.seed, device=device)
    if not args.skip_calibration:
        # calibration inference is small: it runs on the CPU, so its numbers
        # do not depend on the card the training ran on (as the JAX package
        # runs it on its CPU backend)
        calibrate_threshold(emb_dir, seed=args.seed, device="cpu")
        calibrate_single_cutoff(emb_dir, seed=args.seed, device="cpu")


if __name__ == "__main__":
    main()

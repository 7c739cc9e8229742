"""Speaker diarization: the stage (``diarize``) and the serving tier.

Counterpart of ``modular_audio_pipeline_tpu/diarizer.py``.
``diarize(path)`` reads the previous stage's published buffer: a device
tensor goes through :meth:`SpeakerDiarizer.diarize_device_timeline`, a
host array or a file through the host path (the same regions from the
host audio, subsegments cut on the host, the embedder's batches
uploaded). The device timeline:

1. speech regions from the powerset ``SegmentationNet`` over MFCCs of the
   whole timeline, cut into 10 s windows at a 1 s step by ``unfold`` and
   run in chunks of up to 512 windows; the energy classifier's regions
   when no segmentation bundle is shipped or it finds no speech;
2. 1.5 s subsegments at a 0.75 s hop inside the regions, gathered on the
   device from the timeline's 16-sample blocks and embedded by the
   ``ConvEmbedder``; without an embedding bundle, the weight-free
   ``StatsEmbedder``'s span statistics over one MFCC pass of the timeline;
3. calibrated agglomerative clustering on the host;
4. adjacent same-speaker subsegments merged into ``SPEAKER_NN`` turns.

Only activities, embeddings and (for the ``StatsEmbedder``) f16 MFCC
frames cross to the host. As in the JAX package, a bundle that fails to
load degrades to one ``SPEAKER_00`` turn over the whole timeline
(``_use_noop``). :class:`NoOpDiarizer` attributes the whole file to
``SPEAKER_00``. Runs on CUDA unless ``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .audio_io import get_buffer, read_wav
from .config import RetryConfig
from .exceptions import DiarizationError
from .protocols import DiarizationSegment, DiarizerProtocol
from .utils import get_audio_duration, resolve_device, retry_with_backoff

logger = logging.getLogger(__name__)

__all__ = ["SpeakerDiarizer", "NoOpDiarizer", "identify_speakers"]

_SUBSEG_S = 1.5
_SUBSEG_HOP_S = 0.75


def identify_speakers(
    voiceprints: Dict[str, np.ndarray],
    references: Dict[str, np.ndarray],
    threshold: float = 0.5,
) -> Dict[str, str]:
    """Map anonymous ``SPEAKER_NN`` labels to enrolled identities: greedy
    best match by cosine similarity between the per-file voiceprints of
    :meth:`SpeakerDiarizer.diarize_with_embedding` and reference
    embeddings of the same embedder. A label whose best similarity is
    under ``threshold`` stays anonymous; each identity is used once."""
    pairs = []
    for label, v in voiceprints.items():
        v = v / max(float(np.linalg.norm(v)), 1e-8)
        for name, r in references.items():
            r = r / max(float(np.linalg.norm(r)), 1e-8)
            pairs.append((float(np.dot(v, r)), label, name))
    out: Dict[str, str] = {}
    taken_names: set = set()
    for sim, label, name in sorted(pairs, reverse=True):
        if sim < threshold or label in out or name in taken_names:
            continue
        out[label] = name
        taken_names.add(name)
    return out
_BLOCK = 16  # samples per gather block


class SpeakerDiarizer(DiarizerProtocol):
    """Embedding + clustering diarizer with graceful NoOp degradation."""

    supports_buffers = True  # reads audio_io.AudioBuffer hand-offs

    def __init__(
        self,
        weights_path: Optional[str] = None,
        embedding_batch_size: int = 32,
        lazy_load: bool = True,
        device=None,
        model_name: str = "pyannote/speaker-diarization-3.1",
        segmentation_batch_size: int = 32,
    ):
        self.model_name = model_name
        self.weights_path = weights_path
        self.segmentation_batch_size = segmentation_batch_size
        self.embedding_batch_size = embedding_batch_size
        self.device = resolve_device(device)
        self._embedder = None
        self._segmentation = None
        self._use_noop = False
        # AHC cut distance + single-speaker cutoff; None -> clustering
        # defaults; a bundle's calibration.json sets them at load time
        self.ahc_threshold: Optional[float] = None
        self.single_cutoff: Optional[float] = None
        if not lazy_load:
            self.load_model()

    @classmethod
    def from_config(cls, config, device=None) -> "SpeakerDiarizer":
        d = config.diarization
        return cls(
            weights_path=d.weights_path,
            embedding_batch_size=d.embedding_batch_size,
            lazy_load=config.lazy_load_models,
            device=device,
            model_name=d.model,
            segmentation_batch_size=d.segmentation_batch_size,
        )

    def is_loaded(self) -> bool:
        return self._embedder is not None

    def unload_model(self) -> None:
        self._embedder = None

    def load_model(self) -> None:
        if self._embedder is not None or self._use_noop:
            return
        from .utils import find_weights_bundle

        emb_dir = find_weights_bundle("diarization-embedding", explicit=self.weights_path)
        try:
            from .models.diarization.embedding import ConvEmbedder, StatsEmbedder
            from .models.whisper.convert import load_params, unflatten_tree

            if emb_dir is None:
                self._embedder = StatsEmbedder(device=self.device)
                logger.info("Using MFCC-statistics speaker embedder (no checkpoint)")
            else:
                with np.load(emb_dir / "params.npz") as z:
                    tree = unflatten_tree({k: z[k] for k in z.files})
                self._embedder = ConvEmbedder(tree, device=self.device)
                logger.info("Loaded ConvEmbedder weights from %s", emb_dir)
                calib = emb_dir / "calibration.json"
                if calib.exists():
                    cal = json.loads(calib.read_text())
                    if self.ahc_threshold is None:
                        self.ahc_threshold = cal.get("ahc_threshold")
                    if cal.get("single_speaker_cutoff") is not None:
                        self.single_cutoff = float(cal["single_speaker_cutoff"])

            seg_dir = find_weights_bundle("diarization-segmentation")
            if seg_dir is not None:
                from .models.diarization.segmentation import SegmentationNet

                self._segmentation = SegmentationNet(load_params(str(seg_dir)),
                                                     device=self.device)
                logger.info("Loaded segmentation model from %s", seg_dir)
        except Exception as exc:
            # the JAX package degrades to one speaker rather than fail the run
            logger.error("Failed to load diarization model: %s", exc)
            logger.warning("Falling back to NoOp diarization (single speaker)")
            self._embedder = self._segmentation = None
            self._use_noop = True

    # -- speech regions -------------------------------------------------------

    @staticmethod
    def _smooth_speech_flags(speech: np.ndarray) -> np.ndarray:
        """pyannote-style smoothing on the 10 ms grid: fill internal gaps
        <= 400 ms, then drop speech islands <= 200 ms."""
        f = speech.copy()
        n = len(f)
        for value, max_run in ((False, 40), (True, 20)):
            diff = np.flatnonzero(np.diff(f.astype(np.int8)))
            starts = np.concatenate([[0], diff + 1])
            ends = np.concatenate([diff, [n - 1]])
            for s, e in zip(starts, ends):
                if bool(f[s]) is value and e - s + 1 <= max_run:
                    if value is False and (s == 0 or e == n - 1):
                        continue  # keep leading/trailing silence
                    f[s : e + 1] = not value
        return f

    def _segmentation_regions(self, audio: torch.Tensor, sr: int) -> List[tuple]:
        """Speech regions from the segmentation model: 10 s windows at a
        1 s step, overlap-aggregated per-speaker activities, speech where
        any speaker exceeds 0.5, smoothed."""
        from .models.diarization.features import mfcc_batch
        from .models.diarization.segmentation import (
            STEP_S,
            WINDOW_S,
            aggregate_windows,
            sliding_windows,
        )

        n = int(audio.shape[0])
        win = int(WINDOW_S * sr)
        if n <= win:
            spans = sliding_windows(n, sr)
            batch = audio.new_zeros((1, win))
            batch[0, :n] = audio
            mel = mfcc_batch(batch, sr=sr, n_mfcc=40, n_mels=40)
            window_acts = self._segmentation.marginals(mel).float().cpu().numpy()
        else:
            # the MFCCs of the whole timeline once; windows are then views
            # over 1 s frame blocks
            step_frames = int(STEP_S * (sr // 160))
            win_blocks = int(round(WINDOW_S / STEP_S))
            full_mel = mfcc_batch(audio[None], sr=sr, n_mfcc=40, n_mels=40)[0]
            n_steps = full_mel.shape[0] // step_frames
            n_win = max(1, n_steps - win_blocks + 1)
            wins = full_mel[: n_steps * step_frames].unfold(
                0, win_blocks * step_frames, step_frames).transpose(1, 2)  # [n_win, T, 40]
            spans = [(i * int(STEP_S * sr), i * int(STEP_S * sr) + win) for i in range(n_win)]
            # one call per <=512-window chunk, padded to a power-of-two bucket
            chunk_cap, acts = 512, []
            for i in range(0, n_win, chunk_cap):
                n_chunk = min(chunk_cap, n_win - i)
                pad_n = next((c for c in (32, 64, 128, 256, 512) if c >= n_chunk), n_chunk)
                chunk = wins[i : i + n_chunk]
                if n_chunk < pad_n:
                    chunk = torch.cat([chunk, chunk.new_zeros((pad_n - n_chunk,) + chunk.shape[1:])])
                acts.append((self._segmentation.marginals(chunk.contiguous()), n_chunk))
            window_acts = np.concatenate(
                [a.float().cpu().numpy()[:k] for a, k in acts], axis=0)

        global_act = aggregate_windows(window_acts, spans, n, sr)
        speech = self._smooth_speech_flags(global_act.max(axis=-1) > 0.5)
        hop = sr // 100
        idx = np.flatnonzero(speech)
        if idx.size == 0:
            return []
        breaks = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [idx.size - 1]])
        return [(int(idx[s]) * hop, min(n, (int(idx[e]) + 1) * hop))
                for s, e in zip(starts, ends)]

    def _speech_regions_device(self, dev_audio: torch.Tensor, n_valid: int, sr: int
                               ) -> List[tuple]:
        """Segmentation-model regions when loaded, else (or when it finds
        none) the energy classifier's device statistics + host hangover."""
        if self._segmentation is not None:
            regions = self._segmentation_regions(dev_audio, sr)
            regions = [(s, min(e, n_valid)) for s, e in regions if s < n_valid]
            if regions:
                return regions

        from .ops.vad_ops import _MODE_THRESHOLDS, band_energies, hangover_segments

        frame_ms = 30
        frame_len = sr * frame_ms // 1000
        n_frames = n_valid // frame_len
        if n_frames == 0:
            return [(0, n_valid)] if n_valid else []
        bands_d, db_d = band_energies(dev_audio, sr, frame_ms)
        bands = bands_d.cpu().numpy()[:n_frames]
        frame_db = db_d.cpu().numpy()[:n_frames]
        k = max(1, len(bands) // 10)
        floor = np.sort(bands, axis=0)[:k].mean(axis=0) + 1e-12
        score = np.log2(1.0 + bands / floor).sum(axis=-1)
        score_th, db_th = _MODE_THRESHOLDS[1]
        flags = ((score > score_th) & (frame_db > db_th)).astype(np.int32)
        segs = hangover_segments(flags, frame_ms, 300, 0.5, 0.9)
        if not segs:
            return [(0, n_valid)]
        return [(s * frame_len, min(n_valid, (e + 1) * frame_len)) for s, e, _ in segs]

    @staticmethod
    def _subsegments_from_regions(regions: List[tuple], sr: int) -> List[tuple]:
        """(start_sample, end_sample) 1.5 s subsegments at a 0.75 s hop; a
        region shorter than 1.5 s (and over 0.25 s) keeps one, ending at
        the region's end."""
        win = int(_SUBSEG_S * sr)
        hop = int(_SUBSEG_HOP_S * sr)
        out = []
        for region_start, region_end in regions:
            pos = region_start
            while pos + win <= region_end:
                out.append((pos, pos + win))
                pos += hop
            if region_end - region_start < win and region_end - region_start > sr // 4:
                start = max(0, region_end - win)
                out.append((start, start + win))
        return out

    def _embed_device(self, dev_audio: torch.Tensor, spans: List[tuple], sr: int) -> np.ndarray:
        """Embed subsegments gathered on the device from the timeline's
        16-sample blocks (span starts lie on 10 ms frames and 0.75 s hops,
        so on block boundaries: the gather is exact), in power-of-two
        batches of at least ``embedding_batch_size`` and at most 1024. The
        ``StatsEmbedder`` takes one MFCC pass over the timeline instead
        and the span statistics of its f16 frames on the host."""
        from .models.diarization.embedding import StatsEmbedder

        if isinstance(self._embedder, StatsEmbedder):
            from .models.diarization.features import mfcc_batch

            m = mfcc_batch(dev_audio[None], sr=sr, n_mfcc=self._embedder.n_mfcc)
            frames = m[0, :, 1:].half().cpu().numpy().astype(np.float32)
            return self._embedder.embed_spans(frames, np.asarray(spans, dtype=np.int64), sr)
        win = int(_SUBSEG_S * sr)
        win_blocks = win // _BLOCK
        blocks = dev_audio[: (dev_audio.shape[0] // _BLOCK) * _BLOCK].reshape(-1, _BLOCK)
        n_blocks_total = blocks.shape[0]
        max_batch = 1024
        out = []
        for i in range(0, len(spans), max_batch):
            chunk = spans[i : i + max_batch]
            n = len(chunk)
            bucket = min(max_batch, max(self.embedding_batch_size, 1 << (n - 1).bit_length()))
            ids = np.zeros((bucket, win_blocks), dtype=np.int64)
            for j, (s, _e) in enumerate(chunk):
                b0 = min(s // _BLOCK, max(0, n_blocks_total - win_blocks))
                ids[j] = np.arange(b0, b0 + win_blocks)
            batch = blocks[torch.from_numpy(ids).to(blocks.device)].reshape(bucket, win)
            out.append(self._embedder.embed(batch)[:n])
        return np.concatenate(out, axis=0)

    # -- turns ----------------------------------------------------------------

    @staticmethod
    def _turns_from_labels(spans: List[tuple], labels, sr: int) -> List[DiarizationSegment]:
        """Merge adjacent same-label subsegments into speaker turns."""
        segments: List[DiarizationSegment] = []
        cur_label = None
        cur_start = cur_end = 0.0
        for (s, e), lab in zip(spans, labels):
            t0, t1 = s / sr, e / sr
            if cur_label is None:
                cur_label, cur_start, cur_end = int(lab), t0, t1
            elif int(lab) == cur_label and t0 <= cur_end + _SUBSEG_HOP_S:
                cur_end = max(cur_end, t1)
            else:
                segments.append(DiarizationSegment(
                    speaker=f"SPEAKER_{cur_label:02d}", start=round(cur_start, 3),
                    end=round(cur_end, 3), track=str(len(segments))))
                cur_label, cur_start, cur_end = int(lab), t0, t1
        if cur_label is not None:
            segments.append(DiarizationSegment(
                speaker=f"SPEAKER_{cur_label:02d}", start=round(cur_start, 3),
                end=round(cur_end, 3), track=str(len(segments))))
        return segments

    @staticmethod
    def _voiceprints(embeddings, labels) -> Dict[str, np.ndarray]:
        """Per-speaker mean embedding, unit-norm."""
        voiceprints: Dict[str, np.ndarray] = {}
        emb = np.asarray(embeddings, dtype=np.float32)
        lab_arr = np.asarray(labels)
        for lab in np.unique(lab_arr):
            mean = emb[lab_arr == lab].mean(axis=0)
            mean /= max(float(np.linalg.norm(mean)), 1e-8)
            voiceprints[f"SPEAKER_{int(lab):02d}"] = mean
        return voiceprints

    def diarize_device_timeline(
        self,
        dev_audio: torch.Tensor,  # [N] float32 on the device, zero past n_valid
        n_valid: int,
        sr: int,
        min_speakers: int = 2,
        max_speakers: int = 5,
    ) -> Tuple[List[DiarizationSegment], Dict[str, np.ndarray]]:
        """(turns, {speaker: voiceprint}) of a device waveform, without
        downloading it."""
        self.load_model()
        if self._use_noop:
            return [DiarizationSegment(speaker="SPEAKER_00", start=0.0,
                                       end=round(n_valid / sr, 3), track="0")], {}
        regions = self._speech_regions_device(dev_audio, n_valid, sr)
        spans = self._subsegments_from_regions(regions, sr)
        if not spans:
            return [], {}
        embeddings = self._embed_device(dev_audio, spans, sr)
        labels = self._cluster(embeddings, min_speakers, max_speakers)
        return self._turns_from_labels(spans, labels, sr), self._voiceprints(embeddings, labels)

    def _cluster(self, embeddings: np.ndarray, min_speakers: int, max_speakers: int):
        from .models.diarization.clustering import cluster_embeddings

        kw = {}
        if self.ahc_threshold is not None:
            kw["threshold"] = self.ahc_threshold
        if self.single_cutoff is not None:
            kw["single_cutoff"] = self.single_cutoff
        return cluster_embeddings(
            embeddings, min_speakers=min_speakers, max_speakers=max_speakers, **kw)

    # -- host path (a host buffer or a file) -------------------------------------

    def _speech_regions(self, audio: np.ndarray, sr: int) -> List[tuple]:
        """Segmentation-model regions of the host audio when loaded (and
        non-empty), else the energy classifier's."""
        if self._segmentation is not None:
            x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
            regions = self._segmentation_regions(x, sr)
            if regions:
                return regions
        from .ops.vad_ops import frame_speech_flags, hangover_segments

        frame_ms = 30
        flags = frame_speech_flags(audio, sr, frame_ms, 1, device=self.device)
        segs = hangover_segments(flags, frame_ms, 300, 0.5, 0.9)
        spf = sr * frame_ms // 1000
        if not segs:
            return [(0, len(audio))]
        return [(s * spf, min(len(audio), (e + 1) * spf)) for s, e, _ in segs]

    def _subsegments(self, audio: np.ndarray, sr: int) -> List[tuple]:
        return self._subsegments_from_regions(self._speech_regions(audio, sr), sr)

    def _embed_all(self, audio: np.ndarray, sr: int, spans: List[tuple]) -> np.ndarray:
        """Embeddings of host subsegments: the ``StatsEmbedder``'s span
        statistics over one MFCC pass of the file, or the ``ConvEmbedder``
        over power-of-two batches (at least ``embedding_batch_size``, at
        most 1024) of the subsegments cut on the host."""
        from .models.diarization.embedding import StatsEmbedder

        if isinstance(self._embedder, StatsEmbedder):
            frames = self._embedder.frame_features(audio, sr)
            if frames.shape[0] > 1:
                return self._embedder.embed_spans(frames, np.asarray(spans, dtype=np.int64), sr)

        win = int(_SUBSEG_S * sr)
        max_batch = 1024
        out = []
        for i in range(0, len(spans), max_batch):
            chunk = spans[i : i + max_batch]
            n = len(chunk)
            bucket = min(max_batch, max(self.embedding_batch_size, 1 << (n - 1).bit_length()))
            batch = np.zeros((bucket, win), dtype=np.float32)
            for j, (s, e) in enumerate(chunk):
                seg = audio[s:e]
                batch[j, : len(seg)] = seg[:win]
            out.append(self._embedder.embed(torch.from_numpy(batch).to(self.device))[:n])
        return np.concatenate(out, axis=0)

    # -- protocol -------------------------------------------------------------------

    @retry_with_backoff(
        config=RetryConfig(max_attempts=2, initial_delay_s=2.0),
        exceptions=(RuntimeError,),
    )
    def diarize(self, audio_path: str, min_speakers: int = 2, max_speakers: int = 5
                ) -> List[DiarizationSegment]:
        segments, _ = self._diarize_full(audio_path, min_speakers, max_speakers)
        return segments

    def _diarize_full(self, audio_path: str, min_speakers: int = 2, max_speakers: int = 5):
        """``(segments, {speaker: mean unit-norm embedding})``."""
        self.load_model()
        if self._use_noop:
            return NoOpDiarizer().diarize(audio_path, min_speakers, max_speakers), {}
        try:
            buf = get_buffer(audio_path)
            if buf is not None and buf.tensor is not None:
                segments, voiceprints = self.diarize_device_timeline(
                    buf.tensor, buf.n_valid, buf.sr,
                    min_speakers=min_speakers, max_speakers=max_speakers)
            else:
                audio, sr = (buf.as_host(), buf.sr) if buf else read_wav(audio_path)
                spans = self._subsegments(audio, sr)
                if not spans:
                    return [], {}
                embeddings = self._embed_all(audio, sr, spans)
                labels = self._cluster(embeddings, min_speakers, max_speakers)
                segments = self._turns_from_labels(spans, labels, sr)
                voiceprints = self._voiceprints(embeddings, labels)
            logger.info("Diarization: %d turns, %d speakers",
                        len(segments), len(set(s.speaker for s in segments)))
            return segments, voiceprints
        except RuntimeError:
            raise
        except Exception as exc:
            raise DiarizationError(f"Diarization failed for: {audio_path}", details=str(exc))


    def diarize_with_embedding(self, audio_path: str, min_speakers: int = 1,
                               max_speakers: int = 5) -> tuple:
        """``(segments, {speaker: unit-norm mean embedding})``: the turns and
        the voiceprints :func:`identify_speakers` matches across files."""
        return self._diarize_full(audio_path, min_speakers, max_speakers)


class NoOpDiarizer(DiarizerProtocol):
    """Whole file attributed to SPEAKER_00."""

    def is_loaded(self) -> bool:
        return True

    def load_model(self) -> None:
        pass

    def unload_model(self) -> None:
        pass

    def diarize(self, audio_path: str, min_speakers: int = 2, max_speakers: int = 5
                ) -> List[DiarizationSegment]:
        try:
            duration = get_audio_duration(audio_path)
        except Exception:
            duration = 0.0
        return [DiarizationSegment(speaker="SPEAKER_00", start=0.0, end=duration, track="0")]

"""Voice-activity-detection stages, and the DNN VAD bundle's resolution.

Counterpart of ``modular_audio_pipeline_tpu/vad.py``:

- :func:`load_vad_model`: the ``vad-silero`` bundle as a ConvVAD or a
  converted Silero VAD (shared with the serving path);
- :class:`VADFilter`: the WebRTC-style frame classifier
  (``ops.vad_ops.frame_speech_flags``) with the ring-buffer hangover
  machine;
- :class:`SileroVADFilter`: the DNN VAD (energy probabilities without a
  bundle) with Silero's hysteresis post-processing;
- :class:`NoOpVADFilter`: pass-through with an identity mapping.

Each returns ``(output_path, [TimestampMapping])`` with the JAX package's
mapping semantics. ``SileroVADFilter`` cuts a device buffer on the device
when its model is the ConvVAD and every boundary lies on a millisecond;
otherwise (a boundary off the millisecond grid, energy probabilities, the
Silero graph) it cuts on the host, exactly as the JAX package decides.
``last_cut`` names the cut the last call took. Runs on CUDA unless
``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .audio_io import AudioBuffer, get_buffer, publish_buffer, read_stage_input, read_wav
from .exceptions import VADError
from .protocols import TimestampMapping, VADProtocol
from .utils import get_audio_duration, resolve_device

logger = logging.getLogger(__name__)

__all__ = ["VADFilter", "SileroVADFilter", "NoOpVADFilter", "load_vad_model"]


def load_vad_model(threshold: float = 0.5, device=None, weights_path: Optional[str] = None
                   ) -> Tuple[Optional[object], float]:
    """``(model, threshold)`` for the ``vad-silero`` bundle (``weights_path``
    when it exists, else the weight search roots of
    ``utils.weights_search_roots``): a :class:`~.models.vad_net.ConvVAD` on
    ``device`` (None: CUDA) for the trained bundle, a
    :class:`~.models.vad_net.SileroVAD` for a converted torch.hub one, or
    ``(None, threshold)`` when no bundle exists. A shipped
    ``calibration.json`` replaces the default threshold of 0.5; any other
    threshold the caller gives wins."""
    from .models.silero_convert import is_silero_tree
    from .models.vad_net import ConvVAD, SileroVAD
    from .models.whisper.convert import unflatten_tree
    from .utils import find_weights_bundle

    weights_dir = find_weights_bundle("vad-silero", explicit=weights_path)
    if weights_dir is None:
        return None, threshold
    with np.load(weights_dir / "params.npz") as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    if is_silero_tree(tree):
        model: object = SileroVAD(tree, device=device)
        logger.info("Loaded converted Silero VAD from %s", weights_dir)
    else:
        model = ConvVAD(tree, device=device)
        logger.info("Loaded ConvVAD weights from %s", weights_dir)

    calib = weights_dir / "calibration.json"
    if calib.exists() and threshold == 0.5:
        try:
            t = json.loads(calib.read_text()).get("threshold")
            if t is not None:
                threshold = float(t)
                logger.info("Using calibrated VAD threshold %.3f", t)
        except (ValueError, OSError):
            pass
    return model, threshold


class VADFilter(VADProtocol):
    """WebRTC-style VAD with ring-buffer hangover smoothing."""

    supports_buffers = True
    SUPPORTED_SAMPLE_RATES = [8000, 16000, 32000, 48000]
    SUPPORTED_FRAME_DURATIONS = [10, 20, 30]

    def __init__(
        self,
        sample_rate: int = 16000,
        frame_duration_ms: int = 30,
        padding_duration_ms: int = 500,
        start_threshold: float = 0.5,
        stop_threshold: float = 0.9,
        vad_mode: int = 1,
        device=None,
    ):
        if sample_rate not in self.SUPPORTED_SAMPLE_RATES:
            raise VADError(f"Unsupported sample rate: {sample_rate}",
                           details=f"Supported: {self.SUPPORTED_SAMPLE_RATES}")
        if frame_duration_ms not in self.SUPPORTED_FRAME_DURATIONS:
            raise VADError(f"Unsupported frame duration: {frame_duration_ms}ms",
                           details=f"Supported: {self.SUPPORTED_FRAME_DURATIONS}ms")
        if not 0 <= vad_mode <= 3:
            raise VADError(f"VAD mode must be 0-3, got: {vad_mode}")
        self.sample_rate = sample_rate
        self.frame_ms = frame_duration_ms
        self.padding_ms = padding_duration_ms
        self.start_th = start_threshold
        self.stop_th = stop_threshold
        self.mode = vad_mode
        self.device = resolve_device(device)

    @classmethod
    def from_config(cls, config, device=None) -> "VADFilter":
        return cls(
            sample_rate=config.audio.sample_rate,
            frame_duration_ms=config.vad.frame_duration_ms,
            padding_duration_ms=config.vad.padding_duration_ms,
            start_threshold=config.vad.start_threshold,
            stop_threshold=config.vad.stop_threshold,
            vad_mode=config.vad.mode,
            device=device,
        )

    def _segments(self, audio: np.ndarray, sr: int) -> List[Tuple[int, int, int]]:
        from .ops.vad_ops import frame_speech_flags, hangover_segments

        flags = frame_speech_flags(audio, sr, self.frame_ms, self.mode, device=self.device)
        return hangover_segments(flags, self.frame_ms, self.padding_ms, self.start_th,
                                 self.stop_th)

    def detect_speech_segments(self, input_wav: str) -> List[Tuple[float, float]]:
        audio, sr = read_wav(input_wav)
        if sr != self.sample_rate:
            raise VADError(f"Expected {self.sample_rate} Hz audio, got {sr}")
        frame_s = self.frame_ms / 1000.0
        return [(start * frame_s, boundary * frame_s)
                for start, _, boundary in self._segments(audio, sr)]

    def filter_voice(self, input_wav: str, output_dir: str, preserve_timestamps: bool = True
                     ) -> Tuple[str, List[TimestampMapping]]:
        audio, sr = read_stage_input(input_wav)
        if sr != self.sample_rate:
            raise VADError(f"Expected {self.sample_rate} Hz audio, got {sr}")
        spf = sr * self.frame_ms // 1000  # samples per frame
        n_frames = len(audio) // spf
        if n_frames == 0:
            raise VADError("No frames generated from audio")

        segments = self._segments(audio, sr)
        if not segments:
            logger.warning("No voiced segments detected, returning original audio")
            return input_wav, []

        frame_s = self.frame_ms / 1000.0
        pieces: List[np.ndarray] = []
        mappings: List[TimestampMapping] = []
        processed = 0.0
        for start_f, last_f, boundary_f in segments:
            seg_dur = (last_f + 1 - start_f) * frame_s
            if preserve_timestamps:
                mappings.append(TimestampMapping(
                    processed_start=processed, processed_end=processed + seg_dur,
                    original_start=start_f * frame_s, original_end=boundary_f * frame_s))
            pieces.append(audio[start_f * spf : (last_f + 1) * spf])
            processed += seg_dur

        voiced = np.concatenate(pieces)
        out_path = os.path.join(output_dir, f"{Path(input_wav).stem}_voice.wav")
        publish_buffer(out_path, AudioBuffer(sr=sr, n_valid=len(voiced), host=voiced))
        original = n_frames * frame_s
        logger.info("VAD filtered: %s (kept %.1fs, removed %.1fs, %.1f%% voiced)",
                    out_path, processed, original - processed,
                    processed / max(original, 1e-9) * 100)
        return out_path, mappings


class NoOpVADFilter(VADProtocol):
    """Pass-through VAD with a whole-file identity mapping."""

    def filter_voice(self, input_wav: str, output_dir: str
                     ) -> Tuple[str, List[TimestampMapping]]:
        logger.debug("NoOp VAD: passing through unchanged")
        duration = get_audio_duration(input_wav)
        return input_wav, [TimestampMapping(processed_start=0.0, processed_end=duration,
                                            original_start=0.0, original_end=duration)]

    def detect_speech_segments(self, input_wav: str) -> List[Tuple[float, float]]:
        return [(0.0, get_audio_duration(input_wav))]


class SileroVADFilter(VADProtocol):
    """DNN-class VAD with Silero-compatible hysteresis semantics."""

    supports_buffers = True

    def __init__(
        self,
        threshold: float = 0.5,
        sampling_rate: int = 16000,
        min_speech_duration_ms: int = 250,
        weights_path: Optional[str] = None,
        device=None,
    ):
        self.threshold = threshold
        self.sampling_rate = sampling_rate
        self.min_speech_duration_ms = min_speech_duration_ms
        self.weights_path = weights_path
        self.device = resolve_device(device)
        self.model = None
        self._use_energy: Optional[bool] = None  # decided at load
        self.last_cut: Optional[str] = None  # "device" or "host", per filter_voice call

    def _load_model(self) -> None:
        if self.model is not None or self._use_energy is not None:
            return
        from .utils import find_weights_bundle

        if find_weights_bundle("vad-silero", explicit=self.weights_path) is not None:
            try:
                self.model, self.threshold = load_vad_model(
                    self.threshold, device=self.device, weights_path=self.weights_path)
                self._use_energy = False
                return
            except Exception as exc:
                raise VADError(f"Failed to load Silero-class VAD: {exc}")
        self._use_energy = True
        logger.info("No VAD weights; using energy-probability VAD")

    def _probs(self, audio: np.ndarray, sr: int) -> np.ndarray:
        self._load_model()
        if self._use_energy:
            from .models.vad_net import energy_speech_probs

            return energy_speech_probs(audio, sr)
        return self.model.speech_probs(audio, sr)

    def _timestamps(self, audio: np.ndarray, sr: int) -> List[Dict[str, float]]:
        from .models.vad_net import speech_timestamps_from_probs

        return speech_timestamps_from_probs(
            self._probs(audio, sr), sr, threshold=self.threshold,
            min_speech_duration_ms=self.min_speech_duration_ms,
            audio_length_samples=len(audio))

    def detect_speech_segments(self, input_wav: str) -> List[Tuple[float, float]]:
        audio, sr = read_wav(input_wav)
        return [(t["start"], t["end"]) for t in self._timestamps(audio, sr)]

    def _filter_voice_device(self, buf: AudioBuffer, input_wav: str, output_dir: str
                             ) -> Optional[Tuple[str, List[TimestampMapping]]]:
        """The cut of a device buffer on the device: probabilities from the
        padded tensor (the ConvVAD is causal, so padding leaves the valid
        windows' alone), hysteresis on the host, a block-gather concat on
        the device. None when a boundary is not 1 ms aligned: the host
        path then cuts exactly."""
        from .models.vad_net import WINDOW_SAMPLES, speech_timestamps_from_probs
        from .ops.silence import build_cut_plan, gather_cut_device

        sr = buf.sr
        spms = sr // 1000
        nvf = buf.n_valid // WINDOW_SAMPLES
        if nvf == 0:
            return None
        probs = self.model(self.model.features(buf.tensor)).cpu().numpy()[:nvf]
        timestamps = speech_timestamps_from_probs(
            probs, sr, threshold=self.threshold,
            min_speech_duration_ms=self.min_speech_duration_ms,
            audio_length_samples=buf.n_valid)
        if not timestamps:
            logger.warning("No voiced segments detected, returning original audio")
            return input_wav, []

        ranges_ms = []
        for item in timestamps:
            s, e = int(item["start"] * sr), int(item["end"] * sr)
            if s % spms or e % spms:
                return None
            ranges_ms.append((s // spms, e // spms))

        ids1, ids2, rstart, rstep, mappings, out_ms = build_cut_plan(
            ranges_ms, buf.n_valid // spms, spms, silence_margin_ms=0, crossfade=False)
        out, n_out = gather_cut_device(buf.tensor, sr, ids1, ids2, rstart, rstep, out_ms)
        out_path = os.path.join(output_dir, f"{Path(input_wav).stem}_voice.wav")
        publish_buffer(out_path, AudioBuffer(sr=sr, n_valid=n_out, tensor=out))
        processed, original = n_out / sr, buf.n_valid / sr
        logger.info("Silero VAD filtered on the device: %s (kept %.1fs, removed %.1fs, "
                    "%.1f%% voiced)", out_path, processed, original - processed,
                    processed / max(original, 1e-9) * 100)
        return out_path, mappings

    def filter_voice(self, input_wav: str, output_dir: str
                     ) -> Tuple[str, List[TimestampMapping]]:
        from .models.vad_net import ConvVAD

        buf = get_buffer(input_wav)
        if buf is not None and buf.tensor is not None and buf.sr % 1000 == 0:
            self._load_model()
            if (not self._use_energy and isinstance(self.model, ConvVAD)
                    and buf.sr == self.sampling_rate == 16000):
                out = self._filter_voice_device(buf, input_wav, output_dir)
                if out is not None:
                    self.last_cut = "device"
                    return out
                logger.info("VAD boundary off the 1 ms grid: cutting on the host")

        self.last_cut = "host"
        audio, sr = read_stage_input(input_wav)
        timestamps = self._timestamps(audio, sr)
        if not timestamps:
            logger.warning("No voiced segments detected, returning original audio")
            return input_wav, []

        pieces: List[np.ndarray] = []
        mappings: List[TimestampMapping] = []
        processed = 0.0
        for item in timestamps:
            s, e = int(item["start"] * sr), int(item["end"] * sr)
            seg_dur = (e - s) / sr
            mappings.append(TimestampMapping(
                processed_start=processed, processed_end=processed + seg_dur,
                original_start=item["start"], original_end=item["end"]))
            pieces.append(audio[s:e])
            processed += seg_dur

        voiced = np.concatenate(pieces)
        out_path = os.path.join(output_dir, f"{Path(input_wav).stem}_voice.wav")
        publish_buffer(out_path, AudioBuffer(sr=sr, n_valid=len(voiced), host=voiced))
        original = len(audio) / sr
        logger.info("Silero VAD filtered on the host: %s (kept %.1fs, removed %.1fs, "
                    "%.1f%% voiced)", out_path, processed, original - processed,
                    processed / max(original, 1e-9) * 100)
        return out_path, mappings

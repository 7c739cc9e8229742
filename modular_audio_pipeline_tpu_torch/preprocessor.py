"""Audio preprocessor: denoise, normalize, loudness, silence removal.

Counterpart of ``modular_audio_pipeline_tpu/preprocessor.py``: the same
methods, WAV-path-in/WAV-path-out signatures, output file names
(``*_denoised.wav``, ``*_norm.wav``, ``*_loudnorm.wav``,
``*_nosilence.wav``) and constants, over the port's torch ops:

- noise reduction -> ``ops.spectral_gate`` (+ ``ops.noise_detect``)
- peak normalize  -> ``ops.dynamics.peak_normalize``
- loudness        -> ``ops.loudness`` (BS.1770, the -70 LUFS skip)
- silence removal -> ``ops.silence`` (pydub's semantics + crossfades)

Inside ``AudioPipeline`` the path methods read the previous stage's
published buffer (``audio_io.get_buffer``) and publish their output as a
padded device tensor, so the waveform stays on the device from the
denoise to the transcriber; silence detection fetches one f32 per
millisecond. A buffer that only exists on the host (a non-16 kHz
multiple-of-1000 rate, an injected stage) takes the host path of
``remove_silence``. The ``*_array`` forms take and return host arrays.
Runs on CUDA unless ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from .audio_io import AudioBuffer, get_buffer, publish_buffer, read_wav, resample_poly, write_wav
from .config import NoiseReductionConfig
from .exceptions import AudioProcessingError
from .ops.noise_detect import longest_noise_run
from .parallel.mesh import rank_dir
from .protocols import PreprocessorProtocol, TimestampMapping
from .utils import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["AudioPreprocessor"]


def _denoise_device(x: torch.Tensor, noise_start: int, sr: int, prop_decrease: float):
    """Spectral gate of a padded device waveform with the 2 s profile at
    ``noise_start``."""
    from .ops.spectral_gate import spectral_gate_stationary

    clip = x[noise_start : noise_start + 2 * sr]
    return spectral_gate_stationary(x, clip, sr, prop_decrease=prop_decrease)


class AudioPreprocessor(PreprocessorProtocol):
    """Denoise / normalize / silence-strip with timestamp preservation."""

    supports_buffers = True  # consumes/publishes audio_io.AudioBuffer

    def __init__(
        self,
        sample_rate: int,
        temp_dir: str,
        noise_config: Optional[NoiseReductionConfig] = None,
        device=None,
    ):
        self.sample_rate = sample_rate
        self.temp_dir = temp_dir
        self.noise_config = noise_config or NoiseReductionConfig()
        self.device = resolve_device(device)
        os.makedirs(temp_dir, exist_ok=True)

    @classmethod
    def from_config(cls, config, device=None) -> "AudioPreprocessor":
        return cls(
            sample_rate=config.audio.sample_rate,
            temp_dir=rank_dir(config.temp_dir),  # each rank's own under a mesh
            noise_config=config.noise_reduction,
            device=device,
        )

    # -- WAV plumbing ----------------------------------------------------------

    def read_wave(self, path: str) -> Tuple[bytes, int]:
        """Raw PCM16 bytes + sample rate."""
        samples, sr = read_wav(path)
        pcm = np.clip(samples * 32768.0, -32768, 32767).astype(np.int16).tobytes()
        return pcm, sr

    def write_wave(self, path: str, audio: bytes, sample_rate: int) -> None:
        samples = np.frombuffer(audio, dtype=np.int16).astype(np.float32) / 32768.0
        write_wav(path, samples, sample_rate)

    def _out_path(self, input_wav: str, suffix: str) -> str:
        return os.path.join(self.temp_dir, f"{Path(input_wav).stem}_{suffix}.wav")

    def _input_buffer(self, input_wav: str) -> AudioBuffer:
        """Stage input: the previous stage's published buffer when there is
        one, else the file (resampled to the pipeline rate)."""
        buf = get_buffer(input_wav)
        if buf is not None:
            return buf
        audio, sr = read_wav(input_wav)
        if sr != self.sample_rate:
            audio = resample_poly(audio, sr, self.sample_rate)
            sr = self.sample_rate
        return AudioBuffer(sr=sr, n_valid=len(audio), host=audio)

    def _padded(self, audio: np.ndarray, sr: int) -> Tuple[torch.Tensor, int]:
        from .ops.bucketing import pad_to_bucket

        padded, n_valid = pad_to_bucket(np.asarray(audio, np.float32), sr)
        return torch.from_numpy(np.ascontiguousarray(padded)).to(self.device), n_valid

    # -- noise reduction -------------------------------------------------------

    def reduce_stationary_noise_array(
        self, audio: np.ndarray, sr: int, noise_clip: Optional[np.ndarray] = None
    ) -> np.ndarray:
        from .ops.bucketing import tile_to_length
        from .ops.spectral_gate import spectral_gate_stationary

        x, n_valid = self._padded(audio, sr)
        if noise_clip is None:
            n = int(sr * self.noise_config.noise_sample_duration_s)
            noise_clip = audio[:n]
            if self.noise_config.auto_detect_noise:
                run = longest_noise_run(x, n_valid, sr)
                if run is not None:
                    noise_clip = audio[run[0] : run[1]]
                    logger.info("Auto-detected noise segment: %.2fs - %.2fs",
                                run[0] / sr, run[1] / sr)
                else:
                    logger.warning(
                        "No noise segments detected, using first %.1fs as noise profile",
                        self.noise_config.noise_sample_duration_s)

        if len(noise_clip) < 1024:  # too short for a stable spectral profile
            logger.warning("Noise profile too short (%d samples); skipping", len(noise_clip))
            return audio

        # The signal padded to its bucket; the profile TILED to 2 s, which
        # keeps the stationary-noise statistics unbiased where zero padding
        # would not.
        noise = tile_to_length(np.asarray(noise_clip, np.float32), 2 * sr)
        out = spectral_gate_stationary(
            x, torch.from_numpy(np.ascontiguousarray(noise)).to(self.device), sr,
            prop_decrease=self.noise_config.prop_decrease)
        return out.cpu().numpy()[:n_valid]

    def reduce_stationary_noise(self, input_wav: str, noise_sample_path: Optional[str] = None
                                ) -> str:
        if not self.noise_config.enabled:
            logger.info("Noise reduction disabled, skipping")
            return input_wav
        try:
            explicit_clip = noise_sample_path or self.noise_config.noise_sample_path
            buf = self._input_buffer(input_wav)
            out_path = self._out_path(input_wav, "denoised")

            if explicit_clip or buf.n_valid < 2 * buf.sr:
                # an explicit noise profile (exact tiling) or audio shorter
                # than the 2 s profile: the host path
                noise_clip = None
                if explicit_clip:
                    noise_clip, _ = read_wav(explicit_clip)
                    logger.info("Using provided noise sample: %s", explicit_clip)
                reduced = self.reduce_stationary_noise_array(buf.as_host(), buf.sr, noise_clip)
                publish_buffer(out_path, AudioBuffer(sr=buf.sr, n_valid=len(reduced),
                                                     host=reduced))
                logger.info("Noise reduced: %s", out_path)
                return out_path

            # device path: the profile's position from device features, the
            # 2 s profile sliced from the device waveform
            x = buf.as_tensor(self.device)
            sr, n_valid = buf.sr, buf.n_valid
            noise_start = 0
            if self.noise_config.auto_detect_noise:
                run = longest_noise_run(x, n_valid, sr)
                if run is not None:
                    noise_start = min(run[0], max(0, n_valid - 2 * sr))
                    logger.info("Auto-detected noise segment: %.2fs - %.2fs",
                                run[0] / sr, run[1] / sr)
                else:
                    logger.warning(
                        "No noise segments detected, using first %.1fs as noise profile",
                        self.noise_config.noise_sample_duration_s)
            out = _denoise_device(x, noise_start, sr, self.noise_config.prop_decrease)
            publish_buffer(out_path, AudioBuffer(sr=sr, n_valid=n_valid, tensor=out))
            logger.info("Noise reduced: %s", out_path)
            return out_path
        except AudioProcessingError:
            raise
        except Exception as exc:
            raise AudioProcessingError("Noise reduction failed", details=str(exc))

    # -- peak normalization -------------------------------------------------------

    def normalize_audio_array(self, audio: np.ndarray, sr: int) -> Tuple[np.ndarray, int]:
        from .ops.dynamics import peak_normalize

        if sr != self.sample_rate:
            audio = resample_poly(audio, sr, self.sample_rate)
            sr = self.sample_rate
        x, n_valid = self._padded(audio, sr)
        return peak_normalize(x).cpu().numpy()[:n_valid], sr

    def normalize_audio(self, input_wav: str) -> str:
        try:
            from .ops.dynamics import peak_normalize

            buf = self._input_buffer(input_wav)
            out = peak_normalize(buf.as_tensor(self.device))
            out_path = self._out_path(input_wav, "norm")
            publish_buffer(out_path, AudioBuffer(sr=buf.sr, n_valid=buf.n_valid, tensor=out))
            logger.info("Audio normalized: %s", out_path)
            return out_path
        except Exception as exc:
            raise AudioProcessingError("Audio normalization failed", details=str(exc))

    # -- loudness -----------------------------------------------------------------

    def normalize_loudness_array(self, audio: np.ndarray, sr: int, target_lufs: float = -16.0
                                 ) -> Tuple[np.ndarray, bool]:
        """``(audio, changed)``; audio quieter than -70 LUFS is returned
        unchanged. Zero padding falls under the absolute gate, so the
        padded measurement is the valid audio's."""
        from .ops.loudness import measure_and_normalize

        x, n_valid = self._padded(audio, sr)
        out, lufs = measure_and_normalize(x, sr, target_lufs)
        lufs = float(lufs)
        if not np.isfinite(lufs) or lufs < -70:
            logger.warning("Audio is too quiet for LUFS normalization, skipping")
            return audio, False
        return out.cpu().numpy()[:n_valid], True

    def normalize_loudness(self, input_wav: str, target_lufs: float = -16.0) -> str:
        try:
            from .ops.loudness import measure_and_normalize

            buf = self._input_buffer(input_wav)
            out, lufs = measure_and_normalize(buf.as_tensor(self.device), buf.sr, target_lufs)
            lufs = float(lufs)  # one scalar to the host: the skip decision
            if not np.isfinite(lufs) or lufs < -70:
                logger.warning("Audio is too quiet for LUFS normalization, skipping")
                return input_wav
            out_path = self._out_path(input_wav, "loudnorm")
            publish_buffer(out_path, AudioBuffer(sr=buf.sr, n_valid=buf.n_valid, tensor=out))
            logger.info("Loudness normalized to %s LUFS: %s", target_lufs, out_path)
            return out_path
        except Exception as exc:
            raise AudioProcessingError("Loudness normalization failed", details=str(exc))

    # -- silence ------------------------------------------------------------------

    def remove_silence(
        self,
        input_wav: str,
        min_silence_len: int = 250,
        silence_offset_db: float = 40.0,
        silence_margin: int = 100,
        preserve_timestamps: bool = True,
    ) -> Tuple[str, List[TimestampMapping]]:
        from .ops.silence import remove_silence as _remove

        try:
            buf = self._input_buffer(input_wav)
            sr = buf.sr
            out_path = self._out_path(input_wav, "nosilence")
            if buf.tensor is not None and sr % 1000 == 0:
                # device path: per-ms block energies to the host, the cut
                # planned there with pydub's math and gathered on the device
                from .ops.silence import (
                    block_sums_device,
                    build_cut_plan,
                    detect_nonsilent_from_block_sums,
                    gather_cut_device,
                )

                spms = sr // 1000
                n_valid_ms = buf.n_valid // spms
                block_sq = block_sums_device(buf.tensor, spms).cpu().numpy()
                ranges = detect_nonsilent_from_block_sums(
                    block_sq, n_valid_ms, min_silence_len=min_silence_len,
                    silence_offset_db=silence_offset_db, spms=spms)
                if not ranges:
                    logger.warning("No non-silent segments found, returning original")
                    return input_wav, []
                ids1, ids2, rstart, rstep, mappings, out_ms = build_cut_plan(
                    ranges, n_valid_ms, spms, silence_margin_ms=silence_margin,
                    preserve_timestamps=preserve_timestamps)
                out, n_out = gather_cut_device(buf.tensor, sr, ids1, ids2, rstart, rstep, out_ms)
                publish_buffer(out_path, AudioBuffer(sr=sr, n_valid=n_out, tensor=out))
                original_duration = buf.n_valid / sr
                processed_duration = n_out / sr
            else:
                # host path: sample-level cutting of the host waveform
                audio = buf.as_host()
                out, mappings, changed = _remove(
                    audio, sr, min_silence_len=min_silence_len,
                    silence_offset_db=silence_offset_db, silence_margin_ms=silence_margin,
                    preserve_timestamps=preserve_timestamps)
                if not changed:
                    logger.warning("No non-silent segments found, returning original")
                    return input_wav, []
                publish_buffer(out_path, AudioBuffer(sr=sr, n_valid=len(out), host=out))
                original_duration = len(audio) / sr
                processed_duration = len(out) / sr

            removed = original_duration - processed_duration
            logger.info("Silence removed: %s (removed %.1fs, %.1f%%)", out_path, removed,
                        removed / max(original_duration, 1e-9) * 100)
            return out_path, mappings
        except Exception as exc:
            raise AudioProcessingError("Silence removal failed", details=str(exc))

    # -- fused chain ----------------------------------------------------------------

    def preprocess_chain_array(self, audio: np.ndarray, sr: int, denoise: bool = True,
                               target_lufs: float = -16.0) -> Tuple[np.ndarray, dict]:
        """Denoise + peak-normalize + loudness-normalize with one upload and
        one download; returns the processed audio and ``{"lufs": ...}``.
        The loudness gain is unity when the measurement is not finite or
        below -70 LUFS. The noise profile is the 2 s from the detected
        noise run's start."""
        from .ops.dynamics import peak_normalize
        from .ops.loudness import integrated_loudness, normalize_loudness

        x, n_valid = self._padded(audio, sr)
        noise_start = 0
        if denoise and self.noise_config.enabled:
            if self.noise_config.auto_detect_noise:
                run = longest_noise_run(x, n_valid, sr)
                if run is not None:
                    noise_start = min(run[0], max(0, n_valid - 2 * sr))
            x = _denoise_device(x, noise_start, sr, self.noise_config.prop_decrease)
        x2 = peak_normalize(x)
        lufs = integrated_loudness(x2, sr)
        quiet = ~torch.isfinite(lufs) | (lufs < -70.0)
        measured = torch.where(quiet, torch.full_like(lufs, target_lufs), lufs)
        x3 = torch.where(quiet, x2, normalize_loudness(x2, measured, target_lufs))
        return x3.cpu().numpy()[:n_valid], {"lufs": float(lufs)}

    def detect_silence_segments(self, input_wav: str, min_silence_len: int = 500,
                                silence_offset_db: float = 40.0) -> List[Tuple[float, float]]:
        from .ops.dynamics import dbfs
        from .ops.silence import detect_silence_ranges

        audio, sr = read_wav(input_wav)
        level = float(dbfs(torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)))
        ranges = detect_silence_ranges(audio, sr, min_silence_len, level - silence_offset_db)
        return [(s / 1000.0, e / 1000.0) for s, e in ranges]

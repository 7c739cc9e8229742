"""Vocal separation: backend resolution and the file-to-file stage.

Counterpart of ``modular_audio_pipeline_tpu/separator.py``, with its
semantics: the ``separation-<model>`` bundle's :class:`MaskUNet` when it
loads and passes a shape probe, REPET (weight-free) otherwise; the
energy-CV music auto-detection; 5-minute chunks with partial exports and a
final checkpoint. Inside ``AudioPipeline`` :class:`VocalSeparator` reads
the previous stage's published buffer: the music test reduces a device
tensor to one scalar on the device (``ops.music.analyze_device``), and
only a separation that runs copies the waveform to the host. Runs on CUDA
unless ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np

from .audio_io import get_buffer, read_stage_input, write_wav
from .exceptions import VocalSeparationError
from .parallel.mesh import rank_dir
from .utils import CheckpointManager, resolve_device

logger = logging.getLogger(__name__)

__all__ = ["VocalSeparator", "NoOpVocalSeparator", "get_separation_backend",
           "get_device_separation"]


def _load_masknet(model: str, device=None):
    """The MaskUNet of the ``separation-<model>`` bundle on ``device``, or
    None when there is no bundle or it fails to load or to run on 2,048
    zeros (a stale layout degrades to REPET instead of failing every
    chunk)."""
    from .utils import find_weights_bundle

    dev = resolve_device(device)  # no CUDA raises here, not as an unusable bundle
    unet_dir = find_weights_bundle(f"separation-{model}")
    if unet_dir is None:
        return None
    try:
        from .models.separation.unet import MaskUNet
        from .models.whisper.convert import load_params

        net = MaskUNet(load_params(str(unet_dir)), device=dev)
        net.separate(np.zeros(2048, np.float32), 16000)  # shape probe
        logger.info("Separation backend: MaskUNet (%s)", unet_dir)
        return net
    except Exception as exc:
        logger.warning("Separation checkpoint at %s unusable (%s); falling back to REPET",
                       unet_dir, exc)
        return None


def get_separation_backend(model: str, device=None):
    """``fn(chunk [n] float32, sr) -> (vocals, accompaniment)`` on the host:
    the bundle's MaskUNet when it loads, REPET otherwise; the work runs on
    ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    net = _load_masknet(model, dev)
    if net is not None:
        return net.separate

    from .models.separation.repet import repet_separate

    logger.info("Separation backend: REPET (no %s checkpoint)", model)
    return lambda audio, sr: repet_separate(audio, sr, device=dev)


def get_device_separation(model: str, device=None):
    """The bundle's :class:`MaskUNet` for separating device audio, or None
    (REPET has no device path: its period search runs on the host)."""
    return _load_masknet(model, device)


class VocalSeparator:
    """File-to-file vocal isolation with chunking and checkpoint/resume."""

    supports_buffers = True  # reads audio_io.AudioBuffer hand-offs

    def __init__(
        self,
        sample_rate: int,
        temp_dir: str,
        model: str = "htdemucs",
        chunk_minutes: float = 5.0,
        checkpoint_manager: Optional[CheckpointManager] = None,
        device=None,
        timeout_s: int = 600,
    ):
        self.sample_rate = sample_rate
        self.temp_dir = temp_dir
        self.model = model
        self.chunk_minutes = chunk_minutes
        self.timeout_s = timeout_s  # carried for config parity
        self.checkpoint_manager = checkpoint_manager
        self.device = resolve_device(device)
        self._backend_fn = None
        os.makedirs(temp_dir, exist_ok=True)

    @classmethod
    def from_config(cls, config, checkpoint_manager: Optional[CheckpointManager] = None,
                    device=None) -> "VocalSeparator":
        return cls(
            sample_rate=config.audio.sample_rate,
            temp_dir=rank_dir(config.temp_dir),  # each rank's own under a mesh
            model=config.vocal_separation.model,
            chunk_minutes=config.vocal_separation.chunk_minutes,
            checkpoint_manager=checkpoint_manager,
            device=device,
            timeout_s=config.subprocess_timeout_s,
        )

    # -- detection -----------------------------------------------------------

    def _analyze_audio_content(self, input_wav: str) -> dict:
        from .ops.music import analyze_audio_content, analyze_device

        try:
            buf = get_buffer(input_wav)
            if buf is not None and buf.tensor is not None:
                result = analyze_device(buf.tensor, buf.n_valid, buf.sr)
            else:
                audio, sr = read_stage_input(input_wav)
                result = analyze_audio_content(audio, sr, self.device)
            logger.info("Audio analysis: %s", result)
            return result
        except Exception as exc:
            logger.warning("Audio analysis failed: %s, assuming no music", exc)
            return {"has_music": False, "confidence": 0.0, "reason": f"Analysis failed: {exc}"}

    def is_separation_needed(self, input_wav: str) -> bool:
        analysis = self._analyze_audio_content(input_wav)
        return analysis.get("has_music", False) and analysis.get("confidence", 0) > 0.5

    # -- separation ----------------------------------------------------------

    def _process_chunk(self, chunk: np.ndarray, sr: int, chunk_index: int) -> np.ndarray:
        if self._backend_fn is None:
            self._backend_fn = get_separation_backend(self.model, self.device)
        try:
            vocals, _ = self._backend_fn(chunk, sr)
            return vocals
        except Exception as exc:
            raise VocalSeparationError(f"Separation failed on chunk {chunk_index}",
                                       details=str(exc))

    def extract_vocals(self, input_wav: str, force: bool = False) -> str:
        """Path of the vocal stem of ``input_wav`` (``input_wav`` itself
        when auto-detection finds no music and ``force`` is off)."""
        if not force and not self.is_separation_needed(input_wav):
            logger.info("Vocal separation not needed, skipping")
            return input_wav

        if self.checkpoint_manager:  # resume when the input is unchanged
            ckpt = self.checkpoint_manager.get_checkpoint("vocal_separation", input_wav)
            if ckpt and os.path.exists(ckpt.output_file):
                logger.info("Using cached vocals from checkpoint: %s", ckpt.output_file)
                return ckpt.output_file

        audio, sr = read_stage_input(input_wav)
        chunk_samples = int(self.chunk_minutes * 60 * sr)
        n_chunks = max(1, int(np.ceil(len(audio) / chunk_samples)))
        stem = Path(input_wav).stem

        pieces = []
        for chunk_index in range(n_chunks):
            start = chunk_index * chunk_samples
            pieces.append(self._process_chunk(audio[start : start + chunk_samples], sr,
                                              chunk_index))
            # a partial export, so an interrupted long run can be inspected
            if self.checkpoint_manager and chunk_index > 0:
                write_wav(os.path.join(self.temp_dir, f"{stem}_vocals_partial.wav"),
                          np.concatenate(pieces), sr)
            logger.info("Processed chunk %d/%d", chunk_index + 1, n_chunks)

        out_path = os.path.join(self.temp_dir, f"{stem}_vocals.wav")
        write_wav(out_path, np.concatenate(pieces), sr)
        if self.checkpoint_manager:
            self.checkpoint_manager.save_checkpoint(
                step_name="vocal_separation", input_file=input_wav, output_file=out_path,
                metadata={"model": self.model, "chunks": n_chunks})
        logger.info("Vocals extracted: %s", out_path)
        return out_path


class NoOpVocalSeparator:
    """Pass-through separator used when separation is disabled."""

    def extract_vocals(self, input_wav: str) -> str:
        return input_wav

    def is_separation_needed(self, input_wav: str) -> bool:
        return False

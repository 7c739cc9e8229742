"""WAV read/write and host resampling (numpy), for the PyTorch port.

Copied from ``modular_audio_pipeline_tpu/audio_io.py`` (``read_wav``,
``read_wav_raw_int16``, ``write_wav``, ``resample_poly`` and their PCM
helpers) without the stage-buffer registry of the stage-by-stage path.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .exceptions import AudioProcessingError

__all__ = ["read_wav", "read_wav_raw_int16", "write_wav", "to_float32", "to_int16",
           "resample_poly"]

_RIFF = b"RIFF"
_WAVE = b"WAVE"
_FMT = b"fmt "
_DATA = b"data"
_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def to_float32(samples: np.ndarray) -> np.ndarray:
    """Convert integer/float PCM to float32 in [-1, 1]."""
    if samples.dtype == np.float32:
        return samples
    if samples.dtype == np.float64:
        return samples.astype(np.float32)
    if samples.dtype == np.int16:
        return samples.astype(np.float32) / 32768.0
    if samples.dtype == np.int32:
        return samples.astype(np.float32) / 2147483648.0
    if samples.dtype == np.uint8:  # WAV 8-bit is unsigned
        return (samples.astype(np.float32) - 128.0) / 128.0
    raise AudioProcessingError(f"Unsupported PCM dtype: {samples.dtype}")


def to_int16(samples: np.ndarray) -> np.ndarray:
    """Convert float32 [-1, 1] to int16 with clipping (no dither)."""
    if samples.dtype == np.int16:
        return samples
    scaled = np.clip(np.asarray(samples, dtype=np.float32) * 32768.0, -32768, 32767)
    return scaled.astype(np.int16)


def _decode_24bit(raw: bytes) -> np.ndarray:
    """24-bit little-endian PCM -> int32 (sign-extended), vectorised."""
    b = np.frombuffer(raw, dtype=np.uint8)
    n = len(b) // 3
    b = b[: n * 3].reshape(n, 3)
    out = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    out = np.where(out & 0x800000, out - (1 << 24), out)
    return out << 8  # promote to int32 full scale


def read_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Parse a RIFF/WAV file into (float32 samples, sample_rate).

    Handles PCM 8/16/24/32-bit and IEEE float32/64, including
    WAVE_FORMAT_EXTENSIBLE headers. Multi-channel audio is averaged to
    mono when ``mono``.
    """
    try:
        data = Path(path).read_bytes()
    except OSError as exc:
        raise AudioProcessingError(f"Failed to read WAV file: {path}", details=str(exc))

    if len(data) < 44 or data[:4] != _RIFF or data[8:12] != _WAVE:
        raise AudioProcessingError(f"Not a RIFF/WAVE file: {path}")

    fmt = None
    fmt_body = b""
    pcm = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == _FMT:
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif chunk_id == _DATA:
            pcm = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or pcm is None:
        raise AudioProcessingError(f"WAV missing fmt/data chunk: {path}")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _EXTENSIBLE and len(fmt_body) >= 26:
        # The real format tag is the first word of the SubFormat GUID.
        (audio_format,) = struct.unpack_from("<H", fmt_body, 24)

    if audio_format == _IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        samples = np.frombuffer(pcm, dtype=dtype)
    elif bits == 16:
        samples = np.frombuffer(pcm, dtype=np.int16)
    elif bits == 32:
        samples = np.frombuffer(pcm, dtype=np.int32)
    elif bits == 24:
        samples = _decode_24bit(pcm)
    elif bits == 8:
        samples = np.frombuffer(pcm, dtype=np.uint8)
    else:
        raise AudioProcessingError(f"Unsupported WAV bit depth: {bits}")

    out = to_float32(samples)
    if channels > 1:
        n = (len(out) // channels) * channels
        out = out[:n].reshape(-1, channels)
        if mono:
            out = out.mean(axis=1)
    return np.ascontiguousarray(out), sample_rate


def read_wav_raw_int16(path: str) -> Tuple[Optional[np.ndarray], int]:
    """Mono 16-bit PCM WAVs as their raw int16 samples (half the upload
    bytes of f32; the device converts). ``(None, sample_rate)`` for any
    other layout: callers fall back to :func:`read_wav`."""
    try:
        data = Path(path).read_bytes()
    except OSError as exc:
        raise AudioProcessingError(f"Failed to read WAV file: {path}", details=str(exc))
    if len(data) < 44 or data[:4] != _RIFF or data[8:12] != _WAVE:
        raise AudioProcessingError(f"Not a RIFF/WAVE file: {path}")

    fmt = None
    pcm = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        if chunk_id == _FMT:
            fmt = struct.unpack_from("<HHIIHH", data, pos + 8)
        elif chunk_id == _DATA:
            pcm = data[pos + 8 : pos + 8 + chunk_size]
        pos += 8 + chunk_size + (chunk_size & 1)

    if fmt is None or pcm is None:
        raise AudioProcessingError(f"WAV missing fmt/data chunk: {path}")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format != _PCM or channels != 1 or bits != 16:
        return None, sample_rate
    return np.frombuffer(pcm, dtype=np.int16), sample_rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono 16-bit PCM WAV."""
    pcm = to_int16(np.asarray(samples))
    try:
        with wave.open(path, "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(sample_rate)
            wf.writeframes(pcm.tobytes())
    except OSError as exc:
        raise AudioProcessingError(f"Failed to write WAV file: {path}", details=str(exc))


def resample_poly(samples: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy); identity when rates match."""
    if orig_sr == target_sr:
        return samples
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(orig_sr, target_sr)
    return _rp(samples, target_sr // g, orig_sr // g).astype(np.float32)

"""WAV I/O, host resampling, and the stage-to-stage audio hand-off.

Copied from ``modular_audio_pipeline_tpu/audio_io.py``: the RIFF/WAV codec
(``read_wav``, ``read_wav_raw_int16``, ``write_wav``, ``wav_info``),
``resample_poly`` (scipy, on the host), and the registry through which
the stages of ``AudioPipeline`` hand each other their audio
(:class:`AudioBuffer`, :func:`publish_buffer`, :func:`get_buffer`): a
stage publishes the tensor it would have written as a WAV, the next
first-party stage picks it up without a disk read or a device round
trip, and the WAV checkpoint is written on a worker thread.

All pipeline-internal audio is float32 in [-1, 1], mono, at the configured
sample rate.
"""

from __future__ import annotations

import struct
import threading
import wave
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .exceptions import AudioProcessingError

__all__ = ["read_wav", "read_wav_raw_int16", "write_wav", "to_float32", "to_int16",
           "resample_poly", "wav_info", "AudioBuffer", "publish_buffer", "get_buffer",
           "read_stage_input",
           "clear_buffers", "flush_writes", "begin_async_run", "end_async_run"]

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
    if _PENDING or _LAZY:  # async write in flight, or lazily deferred
        flush_writes(path)
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
    if _PENDING or _LAZY:
        flush_writes(path)
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


def wav_info(path: str) -> dict:
    """Header-only metadata: duration, sample_rate, channels, bit depth."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != _RIFF or header[8:12] != _WAVE:
            raise AudioProcessingError(f"Not a RIFF/WAVE file: {path}")
        info = {}
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            chunk_id = chunk_hdr[:4]
            (chunk_size,) = struct.unpack("<I", chunk_hdr[4:])
            if chunk_id == _FMT:
                body = f.read(chunk_size)
                fmt, ch, sr, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
                info.update(sample_rate=sr, channels=ch, bit_depth=bits, codec="pcm")
            else:
                if chunk_id == _DATA:
                    info["data_bytes"] = chunk_size
                f.seek(chunk_size + (chunk_size & 1), 1)
        if "sample_rate" in info and "data_bytes" in info:
            bytes_per_frame = info["channels"] * info["bit_depth"] // 8
            info["duration"] = info["data_bytes"] / (
                info["sample_rate"] * max(1, bytes_per_frame)
            )
        return info


def resample_poly(samples: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy); identity when rates match."""
    if orig_sr == target_sr:
        return samples
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(orig_sr, target_sr)
    return _rp(samples, target_sr // g, orig_sr // g).astype(np.float32)


# --------------------------------------------------------------------------
# In-memory stage hand-off: device/host buffers keyed by WAV path
# --------------------------------------------------------------------------
#
# Stages keep the path-in/path-out protocol surface, but first-party
# components also publish the audio they would have written, as a padded
# tensor on their device or a host array, under the WAV's path. The next
# first-party stage looks the path up and skips the disk read and the
# device round trip; the WAV checkpoint is still written, on a worker
# thread inside an orchestrated run. Components that are not buffer-aware
# (injected ones, the NoOps) read the file; the pipeline flushes the
# pending write before it hands them the path.


@dataclass
class AudioBuffer:
    """Audio published by one pipeline stage for the next.

    One of ``tensor``/``host`` is set at construction; the accessors make
    (and keep) the other on demand. ``tensor`` is padded to its shape
    bucket (``ops.bucketing``) with zeros; ``n_valid`` is the real sample
    count. ``ready`` is the CUDA event recorded on the producing stream
    when a CUDA tensor was published: a reader on another thread (the WAV
    writer) waits on it before copying the tensor to the host.
    """

    sr: int
    n_valid: int
    tensor: Any = None  # torch.Tensor [padded], float32
    host: Optional[np.ndarray] = None  # float32 [n_valid]
    ready: Any = None  # torch.cuda.Event

    def as_host(self) -> np.ndarray:
        if self.host is None:
            if self.ready is not None:
                self.ready.synchronize()
            self.host = self.tensor[: self.n_valid].float().cpu().numpy()
        return self.host

    def as_tensor(self, device):
        """The padded tensor, made from the host copy (padded to its bucket
        and moved to ``device``) when the buffer has none."""
        if self.tensor is None:
            import torch

            from .ops.bucketing import pad_to_bucket

            padded, _ = pad_to_bucket(np.asarray(self.host, np.float32), self.sr)
            self.tensor = torch.from_numpy(np.ascontiguousarray(padded)).to(device)
        return self.tensor


_BUFFERS: Dict[str, AudioBuffer] = {}
_PENDING: Dict[str, Future] = {}
_LAZY: set = set()  # published but deliberately not written (see begin_async_run)
_LAZY_PREFIX: Optional[str] = None
_LOCK = threading.Lock()
_WRITER: Optional[ThreadPoolExecutor] = None
_ASYNC_RUNS = 0  # > 0 while an orchestrated pipeline run is active


def _writer() -> ThreadPoolExecutor:
    global _WRITER
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="wav-writer")
    return _WRITER


def begin_async_run(lazy_prefix: Optional[str] = None) -> None:
    """Enter orchestrated-run mode: checkpoint WAVs are written on a worker
    thread (the orchestrator flushes before a consumer that is not
    buffer-aware). Standalone component calls keep synchronous
    write-then-return semantics.

    ``lazy_prefix``: with the pipeline's checkpointing off, stage WAVs
    under this directory (the run's temp dir) are not written at all
    unless something reads the path, which materialises it on demand
    through :func:`flush_writes`.
    """
    global _ASYNC_RUNS, _LAZY_PREFIX
    with _LOCK:
        _ASYNC_RUNS += 1
        if lazy_prefix:
            _LAZY_PREFIX = str(Path(lazy_prefix).resolve())


def end_async_run() -> None:
    global _ASYNC_RUNS, _LAZY_PREFIX
    with _LOCK:
        _ASYNC_RUNS = max(0, _ASYNC_RUNS - 1)
        if _ASYNC_RUNS == 0:
            _LAZY_PREFIX = None
    flush_writes()


def publish_buffer(path: str, buf: AudioBuffer, write_disk: bool = True) -> AudioBuffer:
    """Register ``buf`` under ``path`` and write the WAV checkpoint:
    on the worker thread inside an orchestrated run (the device-to-host
    copy happens there, off the critical path), synchronously otherwise.
    Paths under the run's lazy prefix defer the write until read."""
    if buf.tensor is not None and buf.tensor.is_cuda and buf.ready is None:
        import torch

        buf.ready = torch.cuda.Event()
        buf.ready.record(torch.cuda.current_stream(buf.tensor.device))
    key = str(Path(path).resolve())
    with _LOCK:
        _BUFFERS[key] = buf
        async_mode = _ASYNC_RUNS > 0
        lazy = async_mode and _LAZY_PREFIX is not None and key.startswith(_LAZY_PREFIX)
        if write_disk and lazy:
            _LAZY.add(key)

    if write_disk and not lazy:
        if async_mode:
            def task():
                write_wav(path, buf.as_host(), buf.sr)

            with _LOCK:
                _PENDING[key] = _writer().submit(task)
        else:
            write_wav(path, buf.as_host(), buf.sr)
    return buf


def get_buffer(path: str) -> Optional[AudioBuffer]:
    with _LOCK:
        return _BUFFERS.get(str(Path(path).resolve()))


def read_stage_input(path: str) -> Tuple[np.ndarray, int]:
    """The previous stage's published buffer as a host array when there is
    one, else the file."""
    buf = get_buffer(path)
    if buf is not None:
        return buf.as_host(), buf.sr
    return read_wav(path)


def flush_writes(path: Optional[str] = None) -> None:
    """Block until pending checkpoint writes finish (all, or one path),
    and materialise a lazily deferred checkpoint when ``path`` names one.
    A full flush (``path=None``) does not materialise lazy checkpoints:
    they exist because checkpointing is off."""
    with _LOCK:
        if path is not None:
            key = str(Path(path).resolve())
            items = [(k, f) for k, f in _PENDING.items() if k == key]
            lazy_buf = _BUFFERS.get(key) if key in _LAZY else None
        else:
            items = list(_PENDING.items())
            lazy_buf = None
    for key_, fut in items:
        fut.result()
        with _LOCK:
            _PENDING.pop(key_, None)
    if path is not None and lazy_buf is not None:
        write_wav(path, lazy_buf.as_host(), lazy_buf.sr)
        with _LOCK:
            _LAZY.discard(str(Path(path).resolve()))


def clear_buffers() -> None:
    """Drop all published buffers (the start of a new file's run) after
    finishing pending writes."""
    flush_writes()
    with _LOCK:
        _BUFFERS.clear()
        _LAZY.clear()

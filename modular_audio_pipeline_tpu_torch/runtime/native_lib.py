"""ctypes loader of the native host runtime, built with ``g++`` on first use.

Counterpart of ``modular_audio_pipeline_tpu/runtime/native_lib.py`` over
the port's own copy of its C++ sources (``runtime/native/``): the DTW
backtrace, PCM conversions, the crossfaded concatenation of silence
removal, and the FLAC and MPEG Layer III decoders in ``libmap_audio``;
the optional libav container shim (``native/av/``, linked against the
system libavformat/libavcodec where they are installed) in ``libmap_av``.

The libraries are built into ``modular_audio_pipeline_tpu_torch/_build/``
under a name that carries a hash of their sources and flags. Concurrent
builders (test workers, a batch and its CLI) take a file lock, compile
to a temporary name and ``os.replace`` it into place, so no process can
load a half-written library. Every entry point returns None without a
toolchain, and the callers keep NumPy fallbacks.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "load_native", "native_dtw_path", "have_native", "native_flac_decode",
    "native_mp3_decode", "native_crossfade_concat", "load_native_av", "have_native_av",
    "native_av_decode", "native_av_probe", "native_av_encode",
]

_SRC_DIR = Path(__file__).resolve().parent / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_AV_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_AV_LIBS = ("-lavformat", "-lavcodec", "-lswresample", "-lavutil")
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_av_lib: Optional[ctypes.CDLL] = None
_av_load_attempted = False


def _library_path(stem: str, sources: List[Path], flags) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources + sorted(_SRC_DIR.glob("*.h")):
        h.update(path.read_bytes())
    return _BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _build_locked(out: Path, sources: List[Path], flags, libs=()) -> Optional[Path]:
    """Compile ``sources`` into ``out`` unless another process already has:
    under an exclusive lock, to a temporary name, moved into place
    atomically. None when the toolchain or a library is missing."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *flags, *[str(s) for s in sources], "-o", str(tmp), *libs]
        try:
            result = subprocess.run(cmd, capture_output=True, timeout=300)
        except (subprocess.SubprocessError, FileNotFoundError) as exc:
            logger.info("native toolchain unavailable (%s); using NumPy fallbacks", exc)
            return None
        if result.returncode != 0:
            logger.info("native build of %s failed: %s", out.name,
                        result.stderr.decode(errors="replace")[-400:])
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)
        return out


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    sources = sorted(_SRC_DIR.glob("*.cc"))
    path = _library_path("libmap_audio", sources, _FLAGS)
    if not path.exists() and _build_locked(path, sources, _FLAGS) is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.dtw_path.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.dtw_path.restype = None
        lib.pcm16_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.pcm16_to_f32.restype = None
        lib.f32_to_pcm16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
        ]
        lib.f32_to_pcm16.restype = None
        lib.crossfade_concat.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.crossfade_concat.restype = ctypes.c_int64
        lib.flac_probe.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.flac_probe.restype = ctypes.c_int64
        lib.flac_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.flac_decode.restype = ctypes.c_int64
        lib.mp3_probe.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mp3_probe.restype = ctypes.c_int64
        lib.mp3_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mp3_decode.restype = ctypes.c_int64
        _lib = lib
        logger.debug("Loaded native runtime from %s", path)
    except OSError as exc:
        logger.warning("Failed to load native runtime: %s", exc)
        _lib = None
    return _lib


def have_native() -> bool:
    return load_native() is not None


# -- libav container shim (separate .so: needs system libavformat/-codec) ------


def load_native_av() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the libav container shim; None where the
    system libav libraries are absent. The core runtime never needs it."""
    global _av_lib, _av_load_attempted
    if _av_lib is not None or _av_load_attempted:
        return _av_lib
    _av_load_attempted = True
    sources = sorted((_SRC_DIR / "av").glob("*.cc"))
    if not sources:
        return None
    path = _library_path("libmap_av", sources, _AV_FLAGS + _AV_LIBS)
    if not path.exists() and _build_locked(path, sources, _AV_FLAGS, _AV_LIBS) is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.av_shim_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.av_shim_decode.restype = ctypes.c_int64
        lib.av_shim_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.av_shim_free.restype = None
        lib.av_shim_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.av_shim_probe.restype = ctypes.c_int32
        lib.av_shim_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
        ]
        lib.av_shim_encode.restype = ctypes.c_int32
        lib.av_shim_have_encoder.argtypes = [ctypes.c_char_p]
        lib.av_shim_have_encoder.restype = ctypes.c_int32
        _av_lib = lib
        logger.debug("Loaded libav container shim from %s", path)
    except OSError as exc:
        logger.info("libav container shim unavailable: %s", exc)
        _av_lib = None
    return _av_lib


def have_native_av() -> bool:
    return load_native_av() is not None


_AV_DECODE_ERRORS = {
    -1: "container open/probe failed",
    -2: "no audio stream in container",
    -3: "no decoder for this codec",
    -4: "decode error",
}


def native_av_decode(path: str):
    """In-process libav decode of any supported container.

    Returns ``(samples [n, channels] float32, sample_rate)``; None when the
    shim is unavailable; ValueError when libav cannot decode the file.
    """
    lib = load_native_av()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int32(0)
    ch = ctypes.c_int32(0)
    n = lib.av_shim_decode(
        str(path).encode(), ctypes.byref(out), ctypes.byref(sr), ctypes.byref(ch)
    )
    if n < 0:
        raise ValueError(_AV_DECODE_ERRORS.get(int(n), f"libav error {n}"))
    try:
        flat = np.ctypeslib.as_array(out, shape=(int(n) * int(ch.value),))
        samples = flat.reshape(-1, int(ch.value)).copy()
    finally:
        lib.av_shim_free(out)
    return samples, int(sr.value)


def native_av_probe(path: str) -> Optional[dict]:
    """Container metadata (duration/rate/channels/codec/bit_rate) via libav."""
    lib = load_native_av()
    if lib is None:
        return None
    duration = ctypes.c_double(0.0)
    sr = ctypes.c_int32(0)
    ch = ctypes.c_int32(0)
    bit_rate = ctypes.c_int64(0)
    name = ctypes.create_string_buffer(64)
    rc = lib.av_shim_probe(
        str(path).encode(), ctypes.byref(duration), ctypes.byref(sr),
        ctypes.byref(ch), ctypes.byref(bit_rate), name, 64,
    )
    if rc < 0:
        return None
    return {
        "duration": float(duration.value),
        "sample_rate": int(sr.value),
        "channels": int(ch.value),
        "codec": name.value.decode(errors="replace"),
        "bit_rate": int(bit_rate.value),
    }


def native_av_encode(
    path: str, samples: np.ndarray, sr: int, codec: str = ""
) -> bool:
    """Encode float32 PCM into the container implied by ``path``.

    Fixture generation for tests (the pipeline itself only decodes). ``samples`` is [n] mono or [n, ch] interleaved float32.
    """
    lib = load_native_av()
    if lib is None:
        return False
    x = np.ascontiguousarray(samples, dtype=np.float32)
    ch = 1 if x.ndim == 1 else x.shape[1]
    rc = lib.av_shim_encode(
        str(path).encode(),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(x.shape[0]), ctypes.c_int32(sr), ctypes.c_int32(ch),
        codec.encode(),
    )
    return rc == 0


def native_dtw_path(cost: np.ndarray) -> Optional[np.ndarray]:
    """C++ DTW backtrace; None when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    cost64 = np.ascontiguousarray(cost, dtype=np.float64)
    s_len, t_len = cost64.shape
    cols = np.zeros(s_len, dtype=np.int64)
    lib.dtw_path(
        cost64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int32(s_len),
        ctypes.c_int32(t_len),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return cols


def native_pcm16_to_f32(pcm: np.ndarray) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    out = np.empty(pcm.shape, dtype=np.float32)
    lib.pcm16_to_f32(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(pcm.size),
    )
    return out


def native_f32_to_pcm16(x: np.ndarray) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.int16)
    lib.f32_to_pcm16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(x.size),
    )
    return out


def native_crossfade_concat(chunks, crossfades_ms, sr: int) -> Optional[np.ndarray]:
    """C++ crossfaded concatenation; None when the native lib is missing."""
    lib = load_native()
    if lib is None or not chunks:
        return None
    spms = sr // 1000
    arrs = [np.ascontiguousarray(c, dtype=np.float32) for c in chunks]
    n = len(arrs)
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrs]
    )
    lens = np.asarray([len(a) for a in arrs], dtype=np.int64)
    xfs = np.zeros(n, dtype=np.int32)
    xfs[1:] = np.asarray([int(x) * spms for x in crossfades_ms], dtype=np.int32)
    out = np.empty(int(lens.sum()), dtype=np.float32)
    written = lib.crossfade_concat(
        ptrs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        xfs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[:written]


_FLAC_ERRORS = {
    -1: "not a FLAC stream",
    -2: "truncated FLAC stream",
    -3: "malformed FLAC stream",
    -4: "decoder capacity exceeded",
    -5: "FLAC frame CRC mismatch",
}

_MP3_ERRORS = {
    -1: "not an MPEG-1 Layer III stream",
    -2: "truncated MP3 stream",
    -3: "malformed MP3 stream",
    -4: "decoder capacity exceeded",
    -6: "unsupported MP3 feature (MPEG-2/2.5 or intensity stereo)",
}


def native_mp3_decode(data: bytes):
    """Decode an MPEG-1 Layer III byte stream with the C++ decoder.

    Returns ``(samples [n, channels] float32, sample_rate)``. Returns
    None when the native library is unavailable; raises ValueError on
    malformed/unsupported input (callers may then try another decoder).
    """
    lib = load_native()
    if lib is None or not hasattr(lib, "mp3_decode"):
        return None

    buf = np.frombuffer(data, dtype=np.uint8)
    sr = ctypes.c_int32(0)
    ch = ctypes.c_int32(0)
    approx = ctypes.c_int64(0)
    rc = lib.mp3_probe(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size),
        ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(approx),
    )
    if rc < 0:
        raise ValueError(_MP3_ERRORS.get(int(rc), f"MP3 error {rc}"))

    capacity = (int(approx.value) + 4 * 1152) * int(ch.value)
    out = np.empty(capacity, dtype=np.float32)
    written = lib.mp3_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(capacity),
        ctypes.byref(sr), ctypes.byref(ch),
    )
    if written < 0:
        raise ValueError(_MP3_ERRORS.get(int(written), f"MP3 error {written}"))
    samples = out[: int(written) * int(ch.value)].reshape(-1, int(ch.value))
    return samples, int(sr.value)


def native_flac_decode(data: bytes):
    """Decode a FLAC byte stream with the C++ decoder.

    Returns ``(samples [n, channels] float32 in [-1, 1], sample_rate)``.
    Returns None when the native library is unavailable; raises
    ValueError on malformed input.
    """
    lib = load_native()
    if lib is None:
        return None

    buf = np.frombuffer(data, dtype=np.uint8)
    sr = ctypes.c_int32(0)
    ch = ctypes.c_int32(0)
    bps = ctypes.c_int32(0)
    total = ctypes.c_int64(0)
    rc = lib.flac_probe(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size),
        ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(bps),
        ctypes.byref(total),
    )
    if rc < 0:
        raise ValueError(_FLAC_ERRORS.get(int(rc), f"FLAC error {rc}"))

    # capacity: STREAMINFO total when known, else a safe upper bound
    # (compressed FLAC is never smaller than ~1 bit/sample => 8x bytes)
    per_ch = int(total.value) or (buf.size * 8 // max(int(bps.value), 1) + 65536)
    capacity = (per_ch + 65536) * int(ch.value)
    out = np.empty(capacity, dtype=np.int32)
    written = lib.flac_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(capacity),
        ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(bps),
    )
    if written < 0:
        raise ValueError(_FLAC_ERRORS.get(int(written), f"FLAC error {written}"))

    samples = out[: int(written)].reshape(-1, int(ch.value))
    scale = 1.0 / float(1 << (int(bps.value) - 1))
    return samples.astype(np.float32) * scale, int(sr.value)

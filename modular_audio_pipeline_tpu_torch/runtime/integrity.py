"""Checksummed device<->host transfers (PyTorch).

Counterpart of ``modular_audio_pipeline_tpu/runtime/integrity.py``. A
transfer that silently returns zeroed or damaged bytes would parse to
empty transcripts or run the model on garbage weights, so the critical
buffers are checksummed on both sides of the link and compared:

- :func:`checksum_device` computes, on the tensors' device, the checksum
  of each tensor's bytes; :func:`host_checksum` computes the same number
  from a host copy (bit for bit the JAX package's function);
- :func:`fetch_verified_many` fetches device tensors and their device
  checksums and verifies the host copies (the decode's tokens and
  log-probabilities, ``models/whisper/decode.finalize_decode``);
- :func:`put_verified` / :func:`put_verified_tree` upload host tensors and
  verify the device copies (the transcriber's weight upload).

Checksum: the wrap-around uint32 sum of the buffer's little-endian 32-bit
words, XORed with a nonzero salt, so a zeroed checksum fetch can never
validate a zeroed data fetch. Addition is exact in modular arithmetic, so
host and device agree whatever the reduction order. On the device the
words are summed in int64 (torch has little uint32 arithmetic); int64
wraps mod 2^64, a multiple of 2^32, so the low 32 bits are exact. The
device checksums come back as one int64 tensor ``[n]`` holding uint32
values.

Unlike the JAX module: 8-byte dtypes are checksummed as two words per
element (the host's byte view) and an upload must keep the host dtype;
an empty list returns empty; a mismatch on upload first fetches the
checksums again before re-uploading anything, and the error says whether
the upload or the checksum fetch failed; a fetch's retry is a fresh
``.cpu()``, as torch keeps no cached host copy.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..exceptions import FetchIntegrityError

logger = logging.getLogger(__name__)

__all__ = ["host_checksum", "checksum_device", "put_verified", "put_verified_tree",
           "fetch_verified_many", "counts"]

# Golden-ratio constant; any fixed nonzero value works (see module doc).
_SALT = np.uint32(0x9E3779B9)
_MASK = 0xFFFFFFFF
_CHUNK = 1 << 24  # elements summed at a time on the device (a multiple of 4)

# verified transfers since import (read by chip_smoke.py)
counts: Dict[str, int] = {"fetch": 0, "upload": 0}


def _words_u32(x: np.ndarray) -> np.ndarray:
    """Reinterpret a fetched host buffer as uint32 words."""
    a = np.ascontiguousarray(x)
    if a.dtype.itemsize == 4:
        return a.view(np.uint32).ravel()
    # Pad odd-sized dtypes out to a whole number of words.
    raw = a.tobytes()
    pad = (-len(raw)) % 4
    if pad:
        raw += b"\0" * pad
    return np.frombuffer(raw, dtype=np.uint32)


def host_checksum(x: np.ndarray) -> np.uint32:
    w = _words_u32(np.asarray(x))
    total = np.uint32(0) if w.size == 0 else np.bitwise_and(
        np.sum(w.astype(np.uint64)), np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)
    return np.bitwise_xor(total, _SALT)


def _host_bytes(x) -> np.ndarray:
    """The raw bytes of a host array or CPU tensor (bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x)


def _word_sum(flat: torch.Tensor) -> torch.Tensor:
    """int64 sum of the little-endian 32-bit words of a 1-D contiguous
    chunk whose byte length is padded out to whole words with zeros."""
    size = flat.element_size()
    if size in (4, 8):  # an 8-byte element is two words, low word first
        return (flat.view(torch.int32).long() & _MASK).sum()
    if size == 2:
        h = flat.view(torch.int16).long() & 0xFFFF
        if h.numel() % 2:
            h = torch.cat([h, h.new_zeros(1)])
        return (h[0::2] + (h[1::2] << 16)).sum()
    b = flat.view(torch.uint8).long()
    pad = (-b.numel()) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    b = b.reshape(-1, 4)
    return (b[:, 0] + (b[:, 1] << 8) + (b[:, 2] << 16) + (b[:, 3] << 24)).sum()


def _checksum_one(t: torch.Tensor) -> torch.Tensor:
    flat = t.detach().contiguous().reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for s in range(0, flat.numel(), _CHUNK):
        total = total + _word_sum(flat[s : s + _CHUNK])
    return (total & _MASK) ^ int(_SALT)


def checksum_device(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The checksum of each tensor, computed where the tensors lie: an
    int64 tensor ``[n]`` of uint32 values (empty for an empty list). Call it
    while the tensors are the ones to be fetched or kept."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((0,), dtype=torch.int64)
    return torch.stack([_checksum_one(t) for t in tensors])


def _fetch(t: torch.Tensor):
    """A fresh host copy: numpy, or a CPU tensor for bfloat16 (numpy has
    no bfloat16)."""
    h = t.detach().cpu()
    return h if h.dtype == torch.bfloat16 else h.numpy()


def put_verified(host_arrays: Sequence[Any], names: Sequence[str], device=None,
                 retries: int = 3) -> List[torch.Tensor]:
    """Upload host arrays (numpy or CPU tensors) to ``device`` and verify
    the device copies against the host checksums; returns the verified
    device tensors in input order.

    On a mismatch the device checksums are fetched once more before any
    buffer is re-uploaded: a damaged checksum fetch must not send the whole
    tree up again. Buffers that still mismatch are uploaded again, up to
    ``retries`` times; then :class:`FetchIntegrityError` says which buffers
    failed and whether the two checksum fetches agreed (the upload failed)
    or not (the checksum fetch failed).
    """
    hosts = [h if isinstance(h, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(h))
             for h in host_arrays]
    if not hosts:
        return []
    counts["upload"] += 1
    expected = np.array([host_checksum(_host_bytes(h)) for h in hosts], np.int64)
    devs = [h.to(device) for h in hosts]
    for h, d, name in zip(hosts, devs, names):
        if d.dtype != h.dtype:
            raise FetchIntegrityError(f"upload of {name} changed its dtype",
                                      details=f"host {h.dtype}, device {d.dtype}")
    bad: List[int] = []
    fetches_agree = True
    for attempt in range(retries + 1):
        chk = checksum_device(devs)
        got = chk.cpu().numpy()
        bad = [i for i in range(len(devs)) if got[i] != expected[i]]
        if bad:
            # rule out a damaged checksum fetch first (4 bytes a buffer)
            again = chk.cpu().numpy()
            fetches_agree = bool(np.array_equal(again, got))
            bad = [i for i in range(len(devs)) if again[i] != expected[i]]
            if not bad:
                logger.warning("upload integrity: the checksum fetch was damaged, "
                               "the uploads verify")
        if not bad:
            if attempt:
                logger.warning("upload integrity recovered after %d re-upload(s)", attempt)
            return devs
        if attempt == retries:
            break
        logger.warning("upload integrity mismatch on %s (attempt %d/%d): re-uploading",
                       [names[i] for i in bad], attempt + 1, retries)
        for i in bad:
            devs[i] = hosts[i].to(device)
    failed = ("the upload: two fetches of the device checksums agree and differ from "
              "the host's" if fetches_agree else
              "the checksum fetch: two fetches of the device checksums differ")
    raise FetchIntegrityError(
        f"host->device upload failed checksum verification after {retries} re-uploads",
        details=f"buffers: {[names[i] for i in bad]}; what failed: {failed}; "
        "retry in a fresh process",
    )


def _leaves(tree, prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _leaves(v, key)
        else:
            yield key, v


def _rebuild(tree, values):
    return {k: _rebuild(v, values) if isinstance(v, dict) else next(values)
            for k, v in tree.items()}


def put_verified_tree(tree: Dict[str, Any], device=None, name: str = "params",
                      retries: int = 3) -> Dict[str, Any]:
    """:func:`put_verified` over a nested dict of host leaves; the same
    tree of verified device tensors (an empty tree gives an empty tree)."""
    items = list(_leaves(tree))
    devs = put_verified([v for _, v in items], [f"{name}/{k}" for k, _ in items],
                        device, retries)
    return _rebuild(tree, iter(devs))


def fetch_verified_many(dev_tensors: Sequence[torch.Tensor], dev_chk: torch.Tensor,
                        names: Sequence[str], retries: int = 3) -> list:
    """Fetch device tensors and their device checksums, verify, retry and
    raise: returns the verified host arrays (numpy; a CPU tensor for
    bfloat16). A mismatch fetches the mismatching buffers and the checksums
    again (fresh ``.cpu()`` copies), up to ``retries`` times; then
    :class:`FetchIntegrityError` (treat it as a degraded link and retry
    the run in a fresh process)."""
    counts["fetch"] += 1
    hosts = [_fetch(t) for t in dev_tensors]
    chk_host = dev_chk.cpu().numpy().astype(np.int64)
    bad: List[int] = []
    for attempt in range(retries + 1):
        expected = np.array([host_checksum(_host_bytes(h)) for h in hosts], np.int64)
        bad = [i for i in range(len(hosts)) if expected[i] != chk_host[i]]
        if not bad:
            if attempt:
                logger.warning("fetch integrity recovered after %d re-fetch(es)", attempt)
            return hosts
        if attempt == retries:
            break
        logger.warning("fetch integrity mismatch on %s (attempt %d/%d): fetching again",
                       [names[i] for i in bad], attempt + 1, retries)
        for i in bad:
            hosts[i] = _fetch(dev_tensors[i])
        chk_host = dev_chk.cpu().numpy().astype(np.int64)
    raise FetchIntegrityError(
        f"device fetch failed checksum verification after {retries} re-fetches",
        details=f"buffers: {[names[i] for i in bad]}; retry in a fresh process",
    )

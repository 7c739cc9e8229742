"""A reader of ``.safetensors`` files that needs only numpy.

The format: an 8-byte little-endian header length, a JSON header that
maps each tensor's name to its ``dtype``, ``shape`` and ``data_offsets``
(from the end of the header), then the tensors' bytes. Each tensor comes
back as a numpy view of a read-only memory map of the file, so a
multi-gigabyte checkpoint is read one tensor at a time as the converters
touch it.

It reads the dtypes that ``safetensors.numpy.load_file`` reads, to the
bit. numpy has no type for ``BF16`` and the ``F8_*`` types: those are
refused with a :class:`ModelLoadError` that names the dtype, except that
``bf16_as_f32=True`` widens ``BF16`` to f32 exactly (the 16 bits become
the high half of the f32 word), as ``ml_dtypes``' ``astype(np.float32)``
does. A widened tensor is read into memory, not mapped. ``bf16_bits=True``
gives ``BF16`` as its raw 16 bits (``uint16``), mapped like the other
types, for a caller that keeps them as bf16.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict

import numpy as np

from ..exceptions import ModelLoadError

__all__ = ["load_safetensors", "SAFETENSORS_DTYPES"]

# safetensors' dtype names -> numpy types (the file is little-endian)
SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "U64": "<u8", "I32": "<i4", "U32": "<u4",
    "I16": "<i2", "U16": "<u2", "I8": "i1", "U8": "u1",
    "BOOL": "?", "C64": "<c8",
}
_MAX_HEADER = 100 * 1024 * 1024  # safetensors' own limit on the JSON header


def load_safetensors(path, bf16_as_f32: bool = False,
                     bf16_bits: bool = False) -> Dict[str, np.ndarray]:
    """``path`` -> {tensor name: array}, in the file's dtypes and shapes
    (``BF16`` as f32 where ``bf16_as_f32``, as its bits where
    ``bf16_bits``)."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ModelLoadError(f"{path}: not a safetensors file (shorter than its header length)")
        (n,) = struct.unpack("<Q", head)
        if n > min(size - 8, _MAX_HEADER):
            raise ModelLoadError(f"{path}: header length {n} does not fit a {size}-byte file")
        try:
            header = json.loads(f.read(n))
        except ValueError as exc:
            raise ModelLoadError(f"{path}: the safetensors header is not JSON: {exc}") from exc
    base = 8 + n
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=base, shape=(size - base,))
            if size > base else b"")
    out: Dict[str, np.ndarray] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dt = spec["dtype"]
        bits = bf16_bits and dt == "BF16"
        widen = bf16_as_f32 and dt == "BF16" and not bits
        if dt not in SAFETENSORS_DTYPES and not (widen or bits):
            raise ModelLoadError(
                f"{path}: tensor '{name}' is {dt}, a dtype this reader does not read",
                details="Readable: " + ", ".join(SAFETENSORS_DTYPES)
                + ". Save the checkpoint in F32 or F16 first.",
            )
        dtype = np.dtype("<u2" if widen or bits else SAFETENSORS_DTYPES[dt])
        shape = tuple(int(s) for s in spec["shape"])
        start, end = (int(o) for o in spec["data_offsets"])
        count = math.prod(shape)
        if not 0 <= start <= end <= size - base or end - start != count * dtype.itemsize:
            raise ModelLoadError(
                f"{path}: tensor '{name}' ({dt}, shape {list(shape)}) has data offsets "
                f"[{start}, {end}) that do not fit its size or the file")
        x = np.frombuffer(data, dtype=dtype, count=count, offset=start).reshape(shape)
        out[name] = (x.astype("<u4") << 16).view("<f4") if widen else x
    return out

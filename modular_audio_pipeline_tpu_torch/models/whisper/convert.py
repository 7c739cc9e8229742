"""Whisper checkpoint loading for the PyTorch port.

``params.npz`` bundles are the JAX package's format (a flat ``a/b/c``
keyed archive of the nested parameter tree, ``[L, ...]`` stacked layers,
projections stored ``[in, out]``). The port reads the same files, so both
packages compute with the same weights: :func:`load_params` gives the
numpy tree and :func:`params_from_numpy` turns it into tensors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ...exceptions import ModelLoadError

__all__ = ["flatten_tree", "unflatten_tree", "save_params", "load_params", "params_from_numpy",
           "params_to_numpy", "initial_params"]


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params(params: Dict[str, Any], dst: str) -> None:
    """A nested numpy tree -> ``<dst>/params.npz`` (the JAX package's format)."""
    Path(dst).mkdir(parents=True, exist_ok=True)
    np.savez(Path(dst) / "params.npz", **flatten_tree(params))


def load_params(src: str) -> Dict[str, Any]:
    """``<src>/params.npz`` -> nested numpy tree, with the token embedding
    padded to the 128-row vocab multiple (``model.padded_vocab``) so the
    layout matches the JAX loader's."""
    from .model import padded_vocab

    path = Path(src) / "params.npz"
    if not path.exists():
        raise ModelLoadError(
            f"No converted checkpoint at {src}",
            details="Convert one with modular_audio_pipeline_tpu.models.whisper.convert.",
        )
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    emb_key = "decoder/tok_emb"
    if emb_key in flat:
        emb = flat[emb_key]
        target = padded_vocab(emb.shape[0])
        if target > emb.shape[0]:
            pad = np.zeros((target - emb.shape[0], emb.shape[1]), dtype=emb.dtype)
            flat[emb_key] = np.concatenate([emb, pad], axis=0)
    return unflatten_tree(flat)


def params_from_numpy(
    tree: Dict[str, Any], device="cpu", dtype: torch.dtype = torch.bfloat16
) -> Dict[str, Any]:
    """Nested numpy tree (``params.npz`` or ``np.asarray`` over a JAX tree)
    -> the same tree of tensors on ``device``. Floating leaves become
    ``dtype`` (one round-to-nearest-even cast, as ``ml_dtypes`` does for
    the JAX loader), except the ``*_ws`` scales of a quantised tree
    (``ops/quant.quantize_decoder``), which stay f32 as the JAX tree keeps
    them; integer leaves (the int8 codes) keep their type."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device, dtype)
            continue
        arr = np.ascontiguousarray(np.asarray(v))
        if arr.dtype.kind == "V" or (arr.dtype.kind == "f"
                                     and arr.dtype not in (np.float16, np.float32, np.float64)):
            arr = arr.astype(np.float32)  # ml_dtypes' bfloat16 (kind "V") from a JAX tree
        t = torch.from_numpy(arr)
        if t.is_floating_point():
            t = t.float() if k.endswith("_ws") else t.to(dtype)
        out[k] = t.to(device)
    return out


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: a tree of tensors (a trained
    one included) -> the same tree of host numpy arrays, each in its
    tensor's type, ready for :func:`save_params`."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def initial_params(params, init, seed: int) -> Dict[str, Any]:
    """A trainer's initial parameters: ``params`` as given (a numpy tree in
    the JAX layout), the ``params.npz`` of a bundle dir when ``params`` is a
    path, or ``init(seed)`` when it is None."""
    if params is None:
        return init(seed)
    if isinstance(params, (str, Path)):
        return load_params(str(params))
    return params

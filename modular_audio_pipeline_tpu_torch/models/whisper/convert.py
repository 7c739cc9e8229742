"""Whisper checkpoints for the PyTorch port: conversion and loading.

``params.npz`` bundles are the JAX package's format (a flat ``a/b/c``
keyed archive of the nested parameter tree, ``[L, ...]`` stacked layers,
projections stored ``[in, out]``). The port reads the same files, so both
packages compute with the same weights: :func:`load_params` gives the
numpy tree and :func:`params_from_numpy` turns it into tensors.

:func:`convert_checkpoint` turns a published checkpoint into such a
bundle, as the JAX package's converter does, on a machine without JAX
and without the ``safetensors`` package::

    python -m modular_audio_pipeline_tpu_torch.models.whisper.convert \
        --src /path/to/hf-whisper-dir --dst ~/.cache/map_tpu/whisper-tiny --model tiny

It reads HuggingFace ``WhisperForConditionalGeneration`` directories
(``model.safetensors``, read by ``models/safetensors_reader.py``, or
``pytorch_model.bin``), a ``whisper.pt`` and OpenAI ``.pt`` files (with
or without ``model_state_dict``), and writes one ``params.npz`` with the
JAX converter's keys and arrays, plus the tokenizer assets the source
ships (``vocab.json``, ``merges.txt``, ``tokenizer.json``,
``normalizer.json``). The table is written as the source holds it: the
padding of the token embedding happens at load time.
"""

from __future__ import annotations

import argparse
import logging
import shutil
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ...exceptions import ModelLoadError
from .config import WHISPER_DIMS, WhisperDims

logger = logging.getLogger(__name__)

__all__ = ["flatten_tree", "unflatten_tree", "save_params", "load_params", "params_from_numpy",
           "params_to_numpy", "initial_params", "convert_checkpoint", "CONVERT_COMMAND"]

# how a user turns a published checkpoint into a bundle the port loads
CONVERT_COMMAND = "python -m modular_audio_pipeline_tpu_torch.models.whisper.convert"


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
            details=f"Convert one with {CONVERT_COMMAND}.",
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
    tensor's type, ready for :func:`save_params`; numpy has no bfloat16, so
    a bf16 leaf widens to f32 (exactly)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: params_to_numpy(v) if isinstance(v, dict) else host(v) for k, v in tree.items()}


def initial_params(params, init, seed: int) -> Dict[str, Any]:
    """A trainer's initial parameters: ``params`` as given (a numpy tree in
    the JAX layout), the ``params.npz`` of a bundle dir when ``params`` is a
    path, or ``init(seed)`` when it is None."""
    if params is None:
        return init(seed)
    if isinstance(params, (str, Path)):
        return load_params(str(params))
    return params


def _torch_state_dict(src: Path) -> Dict[str, np.ndarray]:
    """An HF or OpenAI checkpoint -> numpy arrays: a safetensors file in its
    own dtypes, a torch file in f32 (as the JAX converter reads them)."""
    def to_np(t):
        return t.detach().to(torch.float32).cpu().numpy()

    st = src / "model.safetensors"
    if st.exists():
        from ..safetensors_reader import load_safetensors

        return load_safetensors(st)
    for name in ("pytorch_model.bin", "whisper.pt"):
        p = src / name
        if p.exists():
            sd = torch.load(str(p), map_location="cpu", weights_only=True)
            if "model_state_dict" in sd:  # openai layout
                sd = sd["model_state_dict"]
            return {k: to_np(v) for k, v in sd.items()}
    if src.suffix == ".pt":
        ckpt = torch.load(str(src), map_location="cpu", weights_only=True)
        sd = ckpt.get("model_state_dict", ckpt)
        return {k: to_np(v) for k, v in sd.items()}
    raise ModelLoadError(f"No recognised checkpoint in {src}")


def _stack(blocks):
    out = {}
    for key in blocks[0]:
        if isinstance(blocks[0][key], dict):
            out[key] = _stack([b[key] for b in blocks])
        else:
            out[key] = np.stack([b[key] for b in blocks])
    return out


def _attn(g, prefix: str, names: Dict[str, str]) -> Dict[str, np.ndarray]:
    """One attention's projections, ``[out, in]`` in the checkpoint ->
    ``[in, out]`` (k has no bias in Whisper)."""
    return {
        "q_w": g(f"{prefix}.{names['q']}.weight").T,
        "q_b": g(f"{prefix}.{names['q']}.bias"),
        "k_w": g(f"{prefix}.{names['k']}.weight").T,
        "v_w": g(f"{prefix}.{names['v']}.weight").T,
        "v_b": g(f"{prefix}.{names['v']}.bias"),
        "o_w": g(f"{prefix}.{names['o']}.weight").T,
        "o_b": g(f"{prefix}.{names['o']}.bias"),
    }


def _ln(g, name: str) -> Dict[str, np.ndarray]:
    return {"g": g(f"{name}.weight"), "b": g(f"{name}.bias")}


_HF_ATTN = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}
_OPENAI_ATTN = {"q": "query", "k": "key", "v": "value", "o": "out"}


def _from_hf(sd: Dict[str, np.ndarray], dims: WhisperDims) -> Dict[str, Any]:
    """HuggingFace ``WhisperForConditionalGeneration`` names -> the tree."""
    g = sd.__getitem__

    def block(prefix: str, cross: bool) -> Dict[str, Any]:
        p = {
            "attn": _attn(g, f"{prefix}.self_attn", _HF_ATTN),
            "attn_ln": _ln(g, f"{prefix}.self_attn_layer_norm"),
            "mlp": {
                "fc1_w": g(f"{prefix}.fc1.weight").T,
                "fc1_b": g(f"{prefix}.fc1.bias"),
                "fc2_w": g(f"{prefix}.fc2.weight").T,
                "fc2_b": g(f"{prefix}.fc2.bias"),
            },
            "mlp_ln": _ln(g, f"{prefix}.final_layer_norm"),
        }
        if cross:
            p["cross"] = _attn(g, f"{prefix}.encoder_attn", _HF_ATTN)
            p["cross_ln"] = _ln(g, f"{prefix}.encoder_attn_layer_norm")
        return p

    enc = [block(f"model.encoder.layers.{i}", False) for i in range(dims.n_audio_layer)]
    dec = [block(f"model.decoder.layers.{i}", True) for i in range(dims.n_text_layer)]
    return {
        "encoder": {
            "conv1": {"w": g("model.encoder.conv1.weight"), "b": g("model.encoder.conv1.bias")},
            "conv2": {"w": g("model.encoder.conv2.weight"), "b": g("model.encoder.conv2.bias")},
            "blocks": _stack(enc),
            "ln_post": _ln(g, "model.encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": g("model.decoder.embed_tokens.weight"),
            "pos_emb": g("model.decoder.embed_positions.weight"),
            "blocks": _stack(dec),
            "ln": _ln(g, "model.decoder.layer_norm"),
        },
    }


def _from_openai(sd: Dict[str, np.ndarray], dims: WhisperDims) -> Dict[str, Any]:
    """OpenAI whisper names (``encoder.blocks.N.attn.query`` ...) -> the tree."""
    g = sd.__getitem__

    def block(prefix: str, cross: bool) -> Dict[str, Any]:
        p = {
            "attn": _attn(g, f"{prefix}.attn", _OPENAI_ATTN),
            "attn_ln": _ln(g, f"{prefix}.attn_ln"),
            "mlp": {
                "fc1_w": g(f"{prefix}.mlp.0.weight").T,
                "fc1_b": g(f"{prefix}.mlp.0.bias"),
                "fc2_w": g(f"{prefix}.mlp.2.weight").T,
                "fc2_b": g(f"{prefix}.mlp.2.bias"),
            },
            "mlp_ln": _ln(g, f"{prefix}.mlp_ln"),
        }
        if cross:
            p["cross"] = _attn(g, f"{prefix}.cross_attn", _OPENAI_ATTN)
            p["cross_ln"] = _ln(g, f"{prefix}.cross_attn_ln")
        return p

    enc = [block(f"encoder.blocks.{i}", False) for i in range(dims.n_audio_layer)]
    dec = [block(f"decoder.blocks.{i}", True) for i in range(dims.n_text_layer)]
    return {
        "encoder": {
            "conv1": {"w": g("encoder.conv1.weight"), "b": g("encoder.conv1.bias")},
            "conv2": {"w": g("encoder.conv2.weight"), "b": g("encoder.conv2.bias")},
            "blocks": _stack(enc),
            "ln_post": _ln(g, "encoder.ln_post"),
        },
        "decoder": {
            "tok_emb": g("decoder.token_embedding.weight"),
            "pos_emb": g("decoder.positional_embedding"),
            "blocks": _stack(dec),
            "ln": _ln(g, "decoder.ln"),
        },
    }


def convert_checkpoint(src: str, dst: str, model_name: str) -> None:
    """A downloaded checkpoint (directory or ``.pt`` file) -> the bundle
    ``dst`` (``params.npz`` and the tokenizer assets the source ships)."""
    dims = WHISPER_DIMS[model_name]
    src_path = Path(src)
    sd = _torch_state_dict(src_path)
    if any(k.startswith("model.encoder") for k in sd):
        params = _from_hf(sd, dims)
    else:
        params = _from_openai(sd, dims)
    save_params(params, dst)
    src_dir = src_path if src_path.is_dir() else src_path.parent
    for asset in ("vocab.json", "merges.txt", "tokenizer.json", "normalizer.json"):
        p = src_dir / asset
        if p.exists():
            shutil.copy(p, Path(dst) / asset)
    logger.info("Converted %s -> %s", src, dst)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", required=True, help="HF directory, whisper.pt directory or .pt file")
    ap.add_argument("--dst", required=True, help="bundle directory to write params.npz into")
    ap.add_argument("--model", required=True, choices=sorted(WHISPER_DIMS))
    args = ap.parse_args(argv)
    convert_checkpoint(args.src, args.dst, args.model)


if __name__ == "__main__":
    main()

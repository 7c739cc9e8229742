"""Offline Silero-VAD weight conversion (TorchScript -> ``params.npz``).

Counterpart of ``modular_audio_pipeline_tpu/models/silero_convert.py``,
writing the same bundle layout, so either package reads what the other
writes. Silero VAD comes from ``torch.hub`` (network access); convert a
``silero_vad.jit`` fetched elsewhere::

    python -m modular_audio_pipeline_tpu_torch.models.silero_convert \\
        --src silero_vad.jit --dst ~/.cache/map_tpu/vad-silero

``vad.load_vad_model`` then loads :class:`~.vad_net.SileroVAD` from the
bundle. Every key of the published v5 state_dict is shape-checked, so a
changed upstream layout fails here instead of giving wrong weights.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["EXPECTED_SHAPES", "convert_state_dict", "convert", "is_silero_tree"]

# Published silero-vad v5 (16 kHz branch) state_dict layout.
EXPECTED_SHAPES: Dict[str, tuple] = {
    "_model.stft.forward_basis_buffer": (258, 1, 256),
    "_model.encoder.0.reparam_conv.weight": (128, 129, 3),
    "_model.encoder.0.reparam_conv.bias": (128,),
    "_model.encoder.1.reparam_conv.weight": (64, 128, 3),
    "_model.encoder.1.reparam_conv.bias": (64,),
    "_model.encoder.2.reparam_conv.weight": (64, 64, 3),
    "_model.encoder.2.reparam_conv.bias": (64,),
    "_model.encoder.3.reparam_conv.weight": (128, 64, 3),
    "_model.encoder.3.reparam_conv.bias": (128,),
    "_model.decoder.rnn.weight_ih": (512, 128),
    "_model.decoder.rnn.weight_hh": (512, 128),
    "_model.decoder.rnn.bias_ih": (512,),
    "_model.decoder.rnn.bias_hh": (512,),
    "_model.decoder.decoder.2.weight": (1, 128, 1),
    "_model.decoder.decoder.2.bias": (1,),
}


def convert_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """torch state_dict (tensors or numpy arrays) -> the bundle's nested
    numpy tree, every expected key shape-checked."""
    def arr(key: str) -> np.ndarray:
        if key not in sd:
            raise ValueError(f"Silero state_dict missing key: {key}")
        v = sd[key]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        want = EXPECTED_SHAPES[key]
        if tuple(v.shape) != want:
            raise ValueError(
                f"Silero key {key}: shape {tuple(v.shape)} != expected {want} "
                "(upstream layout changed: update EXPECTED_SHAPES and the "
                "SileroVAD graph together)"
            )
        return v.astype(np.float32)

    tree: Dict[str, Any] = {
        "stft": {"basis": arr("_model.stft.forward_basis_buffer")},
        "rnn": {
            "w_ih": arr("_model.decoder.rnn.weight_ih"),
            "w_hh": arr("_model.decoder.rnn.weight_hh"),
            "b_ih": arr("_model.decoder.rnn.bias_ih"),
            "b_hh": arr("_model.decoder.rnn.bias_hh"),
        },
        "head": {
            "w": arr("_model.decoder.decoder.2.weight"),
            "b": arr("_model.decoder.decoder.2.bias"),
        },
    }
    for i in range(4):
        tree[f"enc{i}"] = {
            "w": arr(f"_model.encoder.{i}.reparam_conv.weight"),
            "b": arr(f"_model.encoder.{i}.reparam_conv.bias"),
        }
    return tree


def is_silero_tree(tree: Mapping[str, Any]) -> bool:
    """A converted Silero bundle, as opposed to a ConvVAD one."""
    return "stft" in tree and "rnn" in tree


def convert(src: str, dst: str) -> None:
    """Load a TorchScript ``.jit`` (or a ``.pt`` state_dict) and write the
    converted tree as ``dst/params.npz``."""
    import torch

    from .whisper.convert import flatten_tree

    path = Path(src)
    try:
        module = torch.jit.load(str(path), map_location="cpu")
        sd = dict(module.state_dict())
    except RuntimeError:  # not TorchScript: a saved state_dict or module
        obj = torch.load(str(path), map_location="cpu", weights_only=True)
        sd = dict(obj.state_dict()) if hasattr(obj, "state_dict") else dict(obj)

    Path(dst).mkdir(parents=True, exist_ok=True)
    np.savez(Path(dst) / "params.npz", **flatten_tree(convert_state_dict(sd)))
    logger.info("Converted Silero VAD -> %s", dst)


def main() -> None:
    import argparse

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="silero_vad.jit / .pt path")
    ap.add_argument("--dst", required=True, help="output bundle dir")
    args = ap.parse_args()
    convert(args.src, args.dst)


if __name__ == "__main__":
    main()

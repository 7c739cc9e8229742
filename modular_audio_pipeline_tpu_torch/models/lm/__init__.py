"""Decoder-only language models for local LLM post-processing.

Counterpart of ``modular_audio_pipeline_tpu/models/lm``: a llama-architecture
model (RMSNorm, RoPE, GQA, SwiGLU) with offline checkpoint conversion and a
generation loop over a preallocated KV cache, so meeting analysis runs on
the same card as transcription; and, in the port alone, DeepSeek-V2
(latent attention over a latent cache, routed and shared experts, YaRN).

:data:`LM_MODELS` maps each local model's name to its configuration
(DeepSeek-V2's states its end-of-text id; llama's is 2), its LM class
and its loader;
``LocalLMAnalyzer`` builds its LM through it.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict

from .deepseek_v2 import DEEPSEEK_V2_CONFIGS, DeepseekV2Config, DeepseekV2LM
from .llama import LLAMA_CONFIGS, LlamaConfig, LlamaLM

__all__ = ["LlamaConfig", "LlamaLM", "LLAMA_CONFIGS", "DeepseekV2Config", "DeepseekV2LM",
           "DEEPSEEK_V2_CONFIGS", "LMModel", "LM_MODELS"]


def _load_llama(weights_dir: str, device, dtype):
    from ..whisper.convert import load_params
    from .llama import params_from_jax

    return params_from_jax(load_params(weights_dir), device, dtype)


def _load_leafwise(weights_dir: str, device, dtype):
    """``params.npz`` one leaf at a time, each cast and moved before the
    next is read, so the host holds one leaf of a large checkpoint (at
    DeepSeek-V2-Lite the routed experts' ``w_gate``, 9.6 GB in bf16). A
    ``uint16`` leaf holds bf16 bits, as ``convert_hf_deepseek_v2`` writes
    them."""
    from pathlib import Path

    import numpy as np
    import torch

    from ...exceptions import ModelLoadError
    from ..whisper.convert import unflatten_tree

    path = Path(weights_dir) / "params.npz"
    if not path.exists():
        raise ModelLoadError(f"No converted checkpoint at {weights_dir}")
    def leaf(a):
        t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype == np.uint16
             else torch.from_numpy(a))
        return t.to(device=device, dtype=dtype)

    with np.load(path) as z:
        return unflatten_tree({k: leaf(z[k]) for k in z.files})


@dataclass(frozen=True)
class LMModel:
    config: Any
    lm: type
    load: Callable  # (weights_dir, device, dtype) -> the parameter tree


LM_MODELS: Dict[str, LMModel] = {
    **{name: LMModel(cfg, LlamaLM, _load_llama) for name, cfg in LLAMA_CONFIGS.items()},
    "deepseek-v2-lite": LMModel(DEEPSEEK_V2_CONFIGS["deepseek-v2-lite"], DeepseekV2LM,
                                _load_leafwise),
}

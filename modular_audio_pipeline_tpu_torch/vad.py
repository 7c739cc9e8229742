"""Resolution of the DNN VAD bundle for the serving path.

Counterpart of ``load_vad_model`` in ``modular_audio_pipeline_tpu/vad.py``.
The stage-by-stage filters of that module (``VADFilter``,
``SileroVADFilter``, ``NoOpVADFilter``) belong to the reference-parity
path (ROADMAP.md §A, item 7).
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["load_vad_model"]


def load_vad_model(threshold: float = 0.5, device=None) -> Tuple[Optional[object], float]:
    """``(model, threshold)`` for the ``vad-silero`` bundle of the weight
    search roots (``utils.weights_search_roots``): a
    :class:`~.models.vad_net.ConvVAD` on ``device`` (None: CUDA) for the trained bundle,
    a :class:`~.models.vad_net.SileroVAD` for a converted torch.hub one, or
    ``(None, threshold)`` when no bundle exists. A shipped
    ``calibration.json`` replaces the default threshold of 0.5; any other
    threshold the caller gives wins."""
    from .models.silero_convert import is_silero_tree
    from .models.vad_net import ConvVAD, SileroVAD
    from .models.whisper.convert import unflatten_tree
    from .utils import find_weights_bundle

    weights_dir = find_weights_bundle("vad-silero")
    if weights_dir is None:
        return None, threshold
    with np.load(weights_dir / "params.npz") as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    if is_silero_tree(tree):
        model: object = SileroVAD(tree, device=device)
        logger.info("Loaded converted Silero VAD from %s", weights_dir)
    else:
        model = ConvVAD(tree, device=device)
        logger.info("Loaded ConvVAD weights from %s", weights_dir)

    calib = weights_dir / "calibration.json"
    if calib.exists() and threshold == 0.5:
        try:
            t = json.loads(calib.read_text()).get("threshold")
            if t is not None:
                threshold = float(t)
                logger.info("Using calibrated VAD threshold %.3f", t)
        except (ValueError, OSError):
            pass
    return model, threshold

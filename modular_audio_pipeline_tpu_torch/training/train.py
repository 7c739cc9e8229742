"""Whisper fine-tuning entry point (PyTorch).

    python -m modular_audio_pipeline_tpu_torch.training.train \\
        --manifest train.jsonl --model tiny --weights ~/.cache/map_tpu/whisper-tiny \\
        --out ./finetuned --epochs 3 --batch-size 8

On several cards, one process per card::

    torchrun --nproc-per-node 4 -m modular_audio_pipeline_tpu_torch.training.train \\
        --manifest train.jsonl --model tiny --out ./finetuned --devices 4 --tp 2

Counterpart of ``modular_audio_pipeline_tpu/training/train.py``, with its
flags and defaults: the train step of :mod:`.whisper_train` (AdamW, weight
decay 0.01, f32) over :class:`.data.TranscriptDataset`. ``--weights`` is a
bundle directory or ``random:SEED``. The checkpoint lands as the same
``params.npz`` the transcribers of both packages load. It runs on the card
(``device="cpu"`` from Python for the CPU). ``--devices`` (0: every rank
of the world) and ``--tp`` make a mesh of ``data = devices // tp`` by
``model = tp`` (the JAX train.py's), whose size must equal the world:
each rank takes its rows of every batch (padded to the data axis with
fully masked rows) and its slices of the parameters, and rank 0 writes
the gathered checkpoint.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["main", "parse_args", "setup", "train_mesh", "pad_batch", "local_batch",
           "to_device"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--manifest", required=True, help="JSONL: {audio, text} per line")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--weights", default=None,
                    help="initial checkpoint dir ('random:SEED' to train from scratch)")
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    ap.add_argument("--language", default="en")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=224)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--devices", type=int, default=0,
                    help="cards (0 = every rank that torchrun started)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree")
    return ap.parse_args(argv)


def train_mesh(args: argparse.Namespace, device=None):
    """The mesh of ``--devices``/``--tp``: ``data = devices // tp`` by
    ``model = tp``, devices 0 meaning the world that torchrun started; None
    for one card. A mesh that is not the world raises ``ShardingError``."""
    import os

    from ..config import TPUConfig
    from ..parallel.mesh import build_mesh
    from ..utils import resolve_device

    n_dev = args.devices or int(os.environ.get("WORLD_SIZE", 1))
    if n_dev <= 1 and args.tp <= 1:
        return None
    shape = {"data": max(1, n_dev // args.tp), "model": args.tp}
    return build_mesh(TPUConfig(mesh_shape=shape), resolve_device(device))


def setup(args: argparse.Namespace, device=None):
    """-> (backend, dataset, state, train_step): the f32 backend with its
    tokenizer (its parameters sliced for this rank under a mesh), the
    manifest's dataset on the backend's device, and the AdamW train step
    (weight decay 0.01) bound to the backend's parameters."""
    from ..models.whisper.config import WHISPER_DIMS
    from ..transcriber import TorchWhisperBackend
    from .data import TranscriptDataset
    from .optim import adamw
    from .whisper_train import make_train_step

    mesh = train_mesh(args, device)
    backend = TorchWhisperBackend(args.model, language=args.language,
                                  weights_path=args.weights, compute_dtype="float32",
                                  device=device, mesh=mesh)
    backend.load()
    dims = WHISPER_DIMS[args.model]
    dataset = TranscriptDataset.from_manifest(
        args.manifest, backend.tokenizer, dims, language=args.language,
        batch_size=args.batch_size, seq_len=args.seq_len, device=str(backend.device))
    init_state, train_step = make_train_step(dims, optimizer=adamw(args.lr, weight_decay=0.01),
                                             mesh=mesh)
    return backend, dataset, init_state(backend.params), train_step


def pad_batch(mel: np.ndarray, tokens: np.ndarray, targets: np.ndarray, data_par: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the batch to a multiple of the data axis; padded rows are fully
    masked (IGNORE_INDEX), so they add nothing to the loss."""
    from .whisper_train import IGNORE_INDEX

    pad = (-mel.shape[0]) % data_par
    if not pad:
        return mel, tokens, targets
    return (np.concatenate([mel, np.zeros((pad,) + mel.shape[1:], mel.dtype)]),
            np.concatenate([tokens, np.zeros((pad,) + tokens.shape[1:], tokens.dtype)]),
            np.concatenate([targets, np.full((pad,) + targets.shape[1:], IGNORE_INDEX,
                                             targets.dtype)]))


def local_batch(batch, mesh):
    """This rank's contiguous block of a padded batch's rows (the batch
    itself without a data axis)."""
    from ..parallel.mesh import shard_batch

    if mesh is None:
        return batch
    return tuple(shard_batch(mesh, x, "data")[0] for x in batch)


def to_device(batch, device) -> Tuple[torch.Tensor, ...]:
    mel, tokens, targets = batch
    return (torch.from_numpy(mel).to(device), torch.from_numpy(tokens).long().to(device),
            torch.from_numpy(targets).long().to(device))


def main(argv: Optional[List[str]] = None, device=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ..models.whisper.convert import params_to_numpy, save_params
    from ..parallel.mesh import axis_size, world_rank
    from ..parallel.sharding import unshard_params

    backend, dataset, state, train_step = setup(args, device)
    mesh = backend.mesh
    data_par = axis_size(mesh, "data")

    global_step = 0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for batch in dataset.batches(epoch=epoch):
            rows = local_batch(pad_batch(*batch, data_par), mesh)
            state, loss = train_step(state, *to_device(rows, backend.device))
            losses.append(float(loss))
            global_step += 1
            if global_step % 50 == 0:
                logger.info("step %d loss %.4f", global_step, losses[-1])
        logger.info("epoch %d: mean loss %.4f (%.1fs)",
                    epoch, float(np.mean(losses)), time.perf_counter() - t0)

    params = unshard_params(state.params)  # every model rank takes part
    if world_rank() == 0:
        save_params(params_to_numpy(params), args.out)
        logger.info("Saved fine-tuned checkpoint to %s", args.out)


if __name__ == "__main__":
    main()

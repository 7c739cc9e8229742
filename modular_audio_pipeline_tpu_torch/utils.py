"""Host utilities of the PyTorch port (copied from the JAX package)."""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import os
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = ["retry_with_backoff", "weights_search_roots", "find_weights_bundle", "not_ported",
           "resolve_device", "CheckpointManager", "get_file_hash"]


def resolve_device(device=None):
    """``None`` means CUDA; asking for CUDA without a CUDA device raises
    rather than drifting to the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an option of the JAX package raises here until its
    ROADMAP.md queue-A item lands."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md §A, '{item}')"
    )


# The JAX package's shipped bundles, read by path (never imported).
SHIPPED_WEIGHTS = Path(__file__).resolve().parents[1] / "modular_audio_pipeline_tpu" / "weights"


def weights_search_roots() -> List[Path]:
    """Roots searched for model bundles, in order, as the JAX package
    searches them: ``MAP_TPU_WEIGHTS`` alone when set; otherwise the user
    cache ``~/.cache/map_tpu`` (a retrained bundle wins), then the shipped
    ``modular_audio_pipeline_tpu/weights``."""
    env = os.environ.get("MAP_TPU_WEIGHTS")
    if env:
        return [Path(env)]
    return [Path(os.path.expanduser("~")) / ".cache" / "map_tpu", SHIPPED_WEIGHTS]


def find_weights_bundle(bundle: str, explicit: Optional[str] = None) -> Optional[Path]:
    """The directory of bundle ``bundle`` (one holding ``params.npz``):
    ``explicit`` when it exists, else the first search root that has
    ``<root>/<bundle>/params.npz``, else None."""
    if explicit:
        p = Path(explicit)
        if p.exists():
            return p
    for root in weights_search_roots():
        cand = root / bundle
        if (cand / "params.npz").exists():
            return cand
    return None


def retry_with_backoff(
    config: Optional[object] = None,
    exceptions: tuple = (Exception,),
    on_retry: Optional[Callable[[Exception, int], None]] = None,
) -> Callable[[Callable[..., T]], Callable[..., T]]:
    """Retry decorator with exponential backoff.

    ``config`` needs ``max_attempts``, ``initial_delay_s``,
    ``exponential_backoff`` and ``max_delay_s`` attributes (a
    :class:`~.config.RetryConfig` works). Delay doubles each attempt, capped
    at ``max_delay_s``. The final failure re-raises the last exception.
    """
    if config is None:
        from .config import RetryConfig

        config = RetryConfig()

    def decorator(fn: Callable[..., T]) -> Callable[..., T]:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> T:
            delay = config.initial_delay_s
            for attempt in range(1, config.max_attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except exceptions as exc:
                    if attempt == config.max_attempts:
                        logger.error(
                            "%s failed after %d attempts: %s",
                            fn.__name__, config.max_attempts, exc,
                        )
                        raise
                    if on_retry is not None:
                        on_retry(exc, attempt)
                    logger.warning(
                        "Attempt %d/%d of %s failed: %s. Retrying in %.1fs...",
                        attempt, config.max_attempts, fn.__name__, exc, delay,
                    )
                    time.sleep(delay)
                    if config.exponential_backoff:
                        delay = min(delay * 2, config.max_delay_s)
            raise RuntimeError("unreachable")  # pragma: no cover

        return wrapper

    return decorator


def get_file_hash(file_path: str, algorithm: str = "md5") -> str:
    """Streaming content hash used as the checkpoint cache key."""
    h = hashlib.new(algorithm)
    with open(file_path, "rb") as f:
        while chunk := f.read(1 << 16):
            h.update(chunk)
    return h.hexdigest()


@dataclass
class Checkpoint:
    """One completed step: (step, input) -> output, keyed by input hash."""

    step_name: str
    input_file: str
    output_file: str
    input_hash: str
    timestamp: float
    metadata: Dict[str, Any]


class CheckpointManager:
    """JSON-persisted step checkpoints for resumable processing.

    Key = ``"{step_name}:{md5(input_file)}"``. A checkpoint is valid only if
    its output file still exists and the input file's content hash is
    unchanged.
    """

    FILENAME = "checkpoints.json"

    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.checkpoint_file = self.checkpoint_dir / self.FILENAME
        self._checkpoints: Dict[str, Checkpoint] = {}
        self._load()

    def _load(self) -> None:
        if not self.checkpoint_file.exists():
            return
        try:
            with open(self.checkpoint_file, "r") as f:
                raw = json.load(f)
            self._checkpoints = {k: Checkpoint(**v) for k, v in raw.items()}
        except (OSError, ValueError, TypeError) as exc:
            logger.warning("Failed to load checkpoints: %s", exc)
            self._checkpoints = {}

    def _save(self) -> None:
        tmp = self.checkpoint_file.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump({k: asdict(v) for k, v in self._checkpoints.items()}, f, indent=2)
        os.replace(tmp, self.checkpoint_file)  # atomic on POSIX

    def get_checkpoint_key(self, step_name: str, input_file: str) -> str:
        return f"{step_name}:{get_file_hash(input_file)}"

    def has_valid_checkpoint(self, step_name: str, input_file: str) -> bool:
        ckpt = self._checkpoints.get(self.get_checkpoint_key(step_name, input_file))
        if ckpt is None or not Path(ckpt.output_file).exists():
            return False
        return get_file_hash(input_file) == ckpt.input_hash

    def get_checkpoint(self, step_name: str, input_file: str) -> Optional[Checkpoint]:
        if self.has_valid_checkpoint(step_name, input_file):
            return self._checkpoints[self.get_checkpoint_key(step_name, input_file)]
        return None

    def save_checkpoint(self, step_name: str, input_file: str, output_file: str,
                        metadata: Optional[Dict[str, Any]] = None) -> None:
        self._checkpoints[self.get_checkpoint_key(step_name, input_file)] = Checkpoint(
            step_name=step_name,
            input_file=input_file,
            output_file=output_file,
            input_hash=get_file_hash(input_file),
            timestamp=time.time(),
            metadata=metadata or {},
        )
        self._save()
        logger.debug("Saved checkpoint for %s", step_name)

    def clear(self) -> None:
        self._checkpoints = {}
        if self.checkpoint_file.exists():
            self.checkpoint_file.unlink()

"""Host utilities of the PyTorch port (copied from the JAX package):
retry, file validation, checkpoint/resume, timestamps, weight search and
the device rule of the entry points."""

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

__all__ = ["retry_with_backoff", "weights_search_roots", "find_weights_bundle",
           "resolve_device", "CheckpointManager", "get_file_hash",
           "validate_file", "ensure_directory", "get_audio_duration", "format_timestamp",
           "parse_timestamp"]


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


def validate_file(
    file_path: str,
    must_exist: bool = True,
    allowed_extensions: Optional[List[str]] = None,
    min_size_bytes: int = 0,
    max_size_bytes: Optional[int] = None,
) -> bool:
    """Validate existence, readability, extension and size of a file.

    Raises :class:`~.exceptions.FileValidationError` naming the first
    violation, with the others in its details; returns True otherwise.
    """
    from .exceptions import FileValidationError

    path = Path(file_path)
    problems: List[str] = []

    if must_exist:
        if not path.exists():
            problems.append(f"file does not exist: {file_path}")
        elif not path.is_file():
            problems.append(f"path is not a regular file: {file_path}")
        elif not os.access(file_path, os.R_OK):
            problems.append(f"file is not readable: {file_path}")

    if allowed_extensions:
        ext = path.suffix.lower()
        if ext not in {e.lower() for e in allowed_extensions}:
            problems.append(
                f"extension {ext!r} not in allowed set {sorted(allowed_extensions)}"
            )

    if must_exist and path.is_file():
        size = path.stat().st_size
        if size < min_size_bytes:
            problems.append(f"file is {size} B, below the {min_size_bytes} B minimum")
        if max_size_bytes is not None and size > max_size_bytes:
            problems.append(f"file is {size} B, above the {max_size_bytes} B maximum")

    if problems:
        raise FileValidationError(problems[0], details="; ".join(problems[1:]) or None)
    return True


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


def ensure_directory(path: str) -> str:
    """mkdir -p; returns the absolute path."""
    abs_path = str(Path(path).resolve())
    os.makedirs(abs_path, exist_ok=True)
    return abs_path


def get_audio_duration(file_path: str) -> float:
    """Duration in seconds of a WAV file (header-only read)."""
    import contextlib
    import wave

    with contextlib.closing(wave.open(file_path, "rb")) as wf:
        return wf.getnframes() / float(wf.getframerate())


def format_timestamp(seconds: float) -> str:
    """Seconds -> ``HH:MM:SS.mmm``."""
    hours = int(seconds // 3600)
    minutes = int((seconds % 3600) // 60)
    secs = seconds % 60
    return f"{hours:02d}:{minutes:02d}:{secs:06.3f}"


def parse_timestamp(timestamp: str) -> float:
    """``HH:MM:SS.mmm`` / ``MM:SS`` / plain seconds -> float seconds."""
    parts = timestamp.split(":")
    if len(parts) == 3:
        h, m, s = parts
        return int(h) * 3600 + int(m) * 60 + float(s)
    if len(parts) == 2:
        m, s = parts
        return int(m) * 60 + float(s)
    return float(timestamp)

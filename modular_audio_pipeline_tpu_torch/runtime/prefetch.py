"""Background file prefetcher: the next file's read, decode and resample
overlap the current file's device work (the serving batch driver).

Copied from ``modular_audio_pipeline_tpu/runtime/prefetch.py``.
"""

from __future__ import annotations

import logging
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["AudioPrefetcher"]


class AudioPrefetcher:
    """Iterate (path, audio, sr) with ``depth`` files decoded ahead."""

    def __init__(
        self,
        paths: List[str],
        loader: Optional[Callable[[str], Tuple[np.ndarray, int]]] = None,
        depth: int = 2,
    ):
        if loader is None:
            from ..audio_io import read_wav

            loader = read_wav
        self._paths = list(paths)
        self._loader = loader
        self._depth = max(1, depth)
        self._pool = ThreadPoolExecutor(
            max_workers=self._depth, thread_name_prefix="audio-prefetch"
        )

    def __iter__(self) -> Iterator[Tuple[str, Optional[np.ndarray], Optional[int], Optional[Exception]]]:
        pending: List[Tuple[str, Future]] = []
        idx = 0
        try:
            while idx < len(self._paths) or pending:
                while idx < len(self._paths) and len(pending) < self._depth:
                    path = self._paths[idx]
                    pending.append((path, self._pool.submit(self._loader, path)))
                    idx += 1
                path, fut = pending.pop(0)
                try:
                    audio, sr = fut.result()
                    yield path, audio, sr, None
                except Exception as exc:  # surface per-file, keep iterating
                    logger.warning("Prefetch failed for %s: %s", path, exc)
                    yield path, None, None, exc
        finally:
            self._pool.shutdown(wait=False, cancel_futures=True)

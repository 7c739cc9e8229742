"""Host utilities of the PyTorch port (copied from the JAX package)."""

from __future__ import annotations

import functools
import logging
import time
from typing import Any, Callable, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = ["retry_with_backoff"]


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

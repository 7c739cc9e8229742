"""The JAX package's native libraries for the port's paired tests.

The JAX loader (``runtime/native_lib.py``) builds into one shared cache
path (``~/.cache/map_tpu``) and keeps a failed load for the life of the
process, so test processes that import at once can each catch another's
half-written file and hold ``None``. :func:`load_jax_native` loads the
library again where that happened, built into a directory of this
process's own under the port's git-ignored ``_build/``, which is removed
once the library is mapped.
"""

import os
import shutil
import tempfile
from pathlib import Path

import pytest

from modular_audio_pipeline_tpu.runtime import native_lib as jax_native

BUILD = Path(__file__).resolve().parents[1] / "modular_audio_pipeline_tpu_torch" / "_build"


def load_jax_native(av: bool = False):
    """The JAX package's core library (``av=True``: its libav shim) in this
    process, or None where this process cannot build or load it either."""
    lib = jax_native._av_lib if av else jax_native._lib
    if lib is not None:
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    own = tempfile.mkdtemp(prefix=f"jax-native-{os.getpid()}-", dir=BUILD)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MAP_TPU_CACHE_DIR", own)
            if av:
                jax_native._av_load_attempted = False
                return jax_native.load_native_av()
            jax_native._load_attempted = False
            return jax_native.load_native()
    finally:
        shutil.rmtree(own, ignore_errors=True)

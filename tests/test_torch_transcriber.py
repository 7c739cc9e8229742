"""The PyTorch port's transcriber held against the JAX package's, and the
port's import boundary.

The shipped proxy bundle (``weights/whisper-tiny-synth-proxy``) decodes the
held-out synthetic sentences of tests/test_synth_asr_regression.py through
both ``WhisperTranscriber``s (float32, beam 5, 128 tokens, int8 KV cache,
segment timestamps); the segments must be equal.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
BUNDLE = ROOT / "modular_audio_pipeline_tpu/weights/whisper-tiny-synth-proxy"


@pytest.fixture(scope="module")
def eval_sentences(tmp_path_factory):
    """The two held-out sentences of test_synth_asr_regression.py."""
    from modular_audio_pipeline_tpu.audio_io import write_wav
    from modular_audio_pipeline_tpu.training.synth_asr import SR, VOCAB, synth_sentence

    root = tmp_path_factory.mktemp("torch_synth_eval")
    rng = np.random.default_rng(500_000)  # the eval stream seed
    out = []
    for i in range(2):
        k = int(rng.integers(12, 27))
        words = rng.integers(0, len(VOCAB), size=k)
        path = root / f"eval_{i}.wav"
        write_wav(str(path), synth_sentence(list(words), rng), SR)
        out.append(str(path))
    return out


def _key(segments):
    return [(s["text"], s["start"], s["end"]) for s in segments]


def test_proxy_bundle_segments_equal_jax(eval_sentences):
    from modular_audio_pipeline_tpu.transcriber import WhisperTranscriber as JaxTranscriber
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    kw = dict(model_name="tiny", language="en", beam_size=5, weights_path=str(BUNDLE),
              word_timestamps=False, max_decode_tokens=128)
    jax_tr = JaxTranscriber(**kw)
    jax_tr._backend.compute_dtype = "float32"
    pt_tr = WhisperTranscriber(**kw, device="cpu")
    pt_tr._backend.compute_dtype = "float32"
    for path in eval_sentences:
        want = jax_tr.transcribe(path)
        got = pt_tr.transcribe(path)
        assert got["segments"], f"no segments for {path}"
        assert _key(got["segments"]) == _key(want["segments"])
        assert got["text"] == want["text"]
        # confidence = mean token log-prob; the logits behind it agree to
        # ~1e-4 (f32 sums in another order through 4+4 layers)
        np.testing.assert_allclose(
            [s["confidence"] for s in got["segments"]],
            [s["confidence"] for s in want["segments"]], rtol=0, atol=5e-4)


def test_default_device_is_cuda():
    """device=None means CUDA: without a CUDA device it raises instead of
    running on the CPU."""
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    if torch.cuda.is_available():
        assert WhisperTranscriber()._backend.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            WhisperTranscriber()


@pytest.mark.parametrize("option, value", [
    ("word_timestamps", True),
    ("chunking", "sequential"),
    ("compute_dtype", "int8"),
    ("temperature", 0.4),
    ("language", "auto"),
])
def test_unported_options_raise(tmp_path, option, value):
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    wav = tmp_path / "tone.wav"
    write_wav(str(wav), np.zeros(1600, np.float32), 16000)
    tr = WhisperTranscriber("test-tiny", language="en", weights_path="random:0", device="cpu")
    setattr(tr._backend, option, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.transcribe(str(wav))


def test_from_config_reads_either_package_config():
    from modular_audio_pipeline_tpu.config import PipelineConfig as JaxConfig
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    for cfg in (PipelineConfig(), JaxConfig(media_dir=str(ROOT))):
        cfg.transcription.model = "test-tiny"
        cfg.transcription.compute_type = "float32"
        cfg.transcription.patience = 2.0
        cfg.transcription.word_timestamps = False
        tr = WhisperTranscriber.from_config(cfg, device="cpu")
        b = tr._backend
        assert (b.model_name, b.compute_dtype, b.patience, b.kv_cache_dtype) == (
            "test-tiny", "float32", 2.0, "int8")
        assert not tr.is_loaded()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import modular_audio_pipeline_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "pkg.WhisperTranscriber\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] in ('jaxlib', 'modular_audio_pipeline_tpu'))\n"
        "assert len(names) >= 15, names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_temperature_ladder_raises_without_retry(tmp_path):
    """A window failing whisper's quality gates would go up the sampling
    ladder, which is not ported: transcribe raises at once, with no retry."""
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    wav = tmp_path / "tone.wav"
    write_wav(str(wav), 0.1 * np.sin(np.arange(16000) / 5.0).astype(np.float32), 16000)
    tr = WhisperTranscriber("test-tiny", language="en", device="cpu", max_decode_tokens=4,
                            weights_path=str(ROOT / "modular_audio_pipeline_tpu/weights/whisper-test-tiny"))
    backend = tr._backend
    backend._needs_fallback = lambda *a: True
    calls = []
    inner = backend.transcribe_array
    backend.transcribe_array = lambda *a: calls.append(1) or inner(*a)
    with pytest.raises(NotImplementedError, match="temperature ladder"):
        tr.transcribe(str(wav))
    assert len(calls) == 1

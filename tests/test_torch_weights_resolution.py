"""Where the port finds a Whisper bundle, held against the JAX package.

``default_weights_dir`` of both packages returns the same path with
``MAP_TPU_WEIGHTS`` set, with a bundle under ``~/.cache/map_tpu`` that
shadows the shipped one, and with nothing found. With no
``weights_path``, the port's ``WhisperTranscriber`` and
``ServingPipeline`` load the bundle the JAX package's transcriber loads,
parameter for parameter. Without a bundle both backends warn at
construction; ``MAP_TPU_ALLOW_RANDOM_WEIGHTS=1`` makes both fall back to
random weights (their initialisations differ by design: another
generator); without it both raise ``ModelLoadError``, and the port's names
its own converter.
"""

import logging
import os
from pathlib import Path

import jax
import numpy as np
import pytest
from test_whisper import DIMS
from test_whisper import TestConvertReadiness as _Readiness
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu import transcriber as jax_transcriber
from modular_audio_pipeline_tpu.exceptions import ModelLoadError as JaxModelLoadError
from modular_audio_pipeline_tpu.models.whisper.convert import flatten_tree, save_params
from modular_audio_pipeline_tpu.models.whisper.model import padded_vocab
from modular_audio_pipeline_tpu_torch import transcriber
from modular_audio_pipeline_tpu_torch.config import PipelineConfig
from modular_audio_pipeline_tpu_torch.exceptions import ModelLoadError
from modular_audio_pipeline_tpu_torch.models.whisper.convert import CONVERT_COMMAND
from modular_audio_pipeline_tpu_torch.serving import ServingPipeline
from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS


@pytest.fixture
def env(tmp_path, monkeypatch):
    """A HOME of the test's own and no bundle root or fallback from outside."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("MAP_TPU_WEIGHTS", raising=False)
    monkeypatch.delenv("MAP_TPU_ALLOW_RANDOM_WEIGHTS", raising=False)
    return monkeypatch


def bundle(root: Path, name: str, seed: int) -> dict:
    """A random test-tiny bundle ``<root>/whisper-<name>`` -> its tree as
    ``load_params`` reads it (table padded)."""
    truth = _Readiness._true_tree(DIMS, np.random.default_rng(seed))
    save_params(truth, str(root / f"whisper-{name}"))
    flat = flatten_tree(truth)
    emb = flat["decoder/tok_emb"]
    pad = padded_vocab(emb.shape[0]) - emb.shape[0]
    flat["decoder/tok_emb"] = np.concatenate([emb, np.zeros((pad, emb.shape[1]), emb.dtype)])
    return flat


def jax_params(model: str) -> dict:
    tr = jax_transcriber.WhisperTranscriber(model, language="en", word_timestamps=False)
    tr._backend.compute_dtype = "float32"
    tr._backend.load()
    return flatten_tree(jax.tree.map(np.asarray, tr._backend.params))


def port_flat(tree) -> dict:
    return flatten_tree(tree)  # np.asarray of each CPU tensor


def leaf_shapes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(leaf_shapes(v, key) if isinstance(v, dict) else {key: tuple(v.shape)})
    return out


def port_transcriber_params(model: str) -> dict:
    tr = transcriber.WhisperTranscriber(model, language="en", word_timestamps=False, device="cpu")
    tr._backend.compute_dtype = "float32"
    tr._backend.load()
    return port_flat(tr._backend.params)


def port_serving_params(model: str) -> dict:
    cfg = PipelineConfig()
    cfg.transcription.model, cfg.transcription.language = model, "en"
    cfg.transcription.compute_type = "float32"
    pipe = ServingPipeline(cfg, device="cpu")
    assert pipe.backend.weights_path is None
    pipe.backend.load()
    return port_flat(pipe.backend.params)


def assert_trees_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", ["env_root", "user_cache_shadows_shipped"])
def test_a_found_bundle_is_the_jax_packages(tmp_path, env, case):
    if case == "env_root":
        root = tmp_path / "weights"
        env.setenv("MAP_TPU_WEIGHTS", str(root))
    else:  # ~/.cache/map_tpu comes before the shipped bundles
        root = tmp_path / "home" / ".cache" / "map_tpu"
        assert (SHIPPED_WEIGHTS / "whisper-test-tiny" / "params.npz").exists()
    root.mkdir(parents=True)
    truth = bundle(root, "test-tiny", seed=3)
    want = str(root / "whisper-test-tiny")
    assert transcriber.default_weights_dir("test-tiny") == jax_transcriber.default_weights_dir(
        "test-tiny") == want
    ref = jax_params("test-tiny")
    assert_trees_equal(ref, truth)
    assert_trees_equal(port_transcriber_params("test-tiny"), ref)
    assert_trees_equal(port_serving_params("test-tiny"), ref)


@pytest.mark.parametrize("case", ["env_root", "user_cache"])
def test_nothing_found(tmp_path, env, caplog, case):
    if case == "env_root":  # the only root, and empty: even the shipped bundles are not searched
        env.setenv("MAP_TPU_WEIGHTS", str(tmp_path / "empty"))
        model, want = "test-tiny", str(tmp_path / "empty" / "whisper-test-tiny")
    else:
        model, want = "tiny", str(SHIPPED_WEIGHTS / "whisper-tiny")
    assert transcriber.default_weights_dir(model) == jax_transcriber.default_weights_dir(
        model) == want
    with caplog.at_level(logging.WARNING):
        jax_tr = jax_transcriber.WhisperTranscriber(model, language="en")
        port_tr = transcriber.WhisperTranscriber(model, language="en", device="cpu")
    warned = [r for r in caplog.records if f"No converted checkpoint at {want}" in r.getMessage()]
    assert sorted(r.name for r in warned) == ["modular_audio_pipeline_tpu.transcriber",
                                             "modular_audio_pipeline_tpu_torch.transcriber"]
    with pytest.raises(JaxModelLoadError):
        jax_tr._backend.load()
    with pytest.raises(ModelLoadError, match=f"No converted Whisper checkpoint for '{model}'") as e:
        port_tr._backend.load()
    assert f"{CONVERT_COMMAND} --src <hf-or-openai-ckpt> --dst {want} --model {model}" in str(
        e.value.details)
    assert port_tr._backend.params is None


def test_random_fallback_when_allowed(tmp_path, env, caplog):
    env.setenv("MAP_TPU_WEIGHTS", str(tmp_path / "empty"))
    env.setenv("MAP_TPU_ALLOW_RANDOM_WEIGHTS", "1")
    with caplog.at_level(logging.WARNING):
        jax_tr = jax_transcriber.WhisperTranscriber("test-tiny", language="en")
        port_tr = transcriber.WhisperTranscriber("test-tiny", language="en", device="cpu")
        assert not [r for r in caplog.records if "No converted checkpoint" in r.getMessage()]
        jax_tr._backend.load()
        port_tr._backend.load()
    fell_back = [r.name for r in caplog.records
                 if "falling back to random weights (MAP_TPU_ALLOW_RANDOM_WEIGHTS=1)"
                 in r.getMessage()]
    assert sorted(fell_back) == ["modular_audio_pipeline_tpu.transcriber",
                                 "modular_audio_pipeline_tpu_torch.transcriber"]
    ref = flatten_tree(jax.tree.map(np.asarray, jax_tr._backend.params))
    assert leaf_shapes(port_tr._backend.params) == {k: v.shape for k, v in ref.items()}
    # as the JAX fallback: the dummy tokenizer, the ladder left armed
    assert type(port_tr._backend.tokenizer).__name__ == type(jax_tr._backend.tokenizer).__name__
    assert port_tr._backend.temperature_fallback is jax_tr._backend.temperature_fallback is True
    assert os.environ["MAP_TPU_ALLOW_RANDOM_WEIGHTS"] == "1"

"""The port's trainer evaluations and the diarization calibration held
against the JAX package, over the shipped bundles: ``evaluate_vad`` and
``calibrate_threshold`` (with ``evaluate_der``) give equal results; SI-SNRs
agree to the 0.01 dB both round to; the single-speaker cutoff to 1e-4
relative (cosine distances of f32 embeddings).
"""

import functools
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.models.whisper.convert import load_params
from modular_audio_pipeline_tpu.training import diarization as jax_diar
from modular_audio_pipeline_tpu.training import separation as jax_sep
from modular_audio_pipeline_tpu.training import vad as jax_vad
from modular_audio_pipeline_tpu_torch.training import diarization as pt_diar
from modular_audio_pipeline_tpu_torch.training import separation as pt_sep
from modular_audio_pipeline_tpu_torch.training import vad as pt_vad

WEIGHTS = Path(__file__).resolve().parents[1] / "modular_audio_pipeline_tpu" / "weights"


def test_evaluate_vad_equals_jax():
    params = load_params(str(WEIGHTS / "vad-silero"))
    assert pt_vad.evaluate_vad(params, n_clips=3, seed=7, device="cpu") == \
        jax_vad.evaluate_vad(params, n_clips=3, seed=7)


def test_evaluate_separation_equals_jax():
    d = str(WEIGHTS / "separation-htdemucs")
    got = pt_sep.evaluate_separation(d, seed=1, count=1, device="cpu")
    want = jax_sep.evaluate_separation(d, seed=1, count=1)
    assert set(got) == set(want)
    for key in want:  # rounded to 0.01 dB by both
        assert abs(got[key] - want[key]) <= 0.01 + 1e-9, key


@pytest.fixture
def embedding_bundle(tmp_path):
    """A copy of the shipped embedder bundle: calibration writes into it."""
    dst = tmp_path / "diarization-embedding"
    shutil.copytree(WEIGHTS / "diarization-embedding", dst)
    return dst


def test_calibration_equals_jax(tmp_path, embedding_bundle, monkeypatch):
    """``calibrate_threshold`` (one threshold; ``evaluate_der`` over one
    conversation per seed stream, 15.9 and 13.7 s at seed 10) and
    ``calibrate_single_cutoff`` (one recording per speaker count) write the
    same calibration.json in both packages: the same cut, the same DER."""
    jax_copy = tmp_path / "jax-bundle"
    shutil.copytree(embedding_bundle, jax_copy)
    for mod in (jax_diar, pt_diar):
        monkeypatch.setattr(mod, "evaluate_der", functools.partial(mod.evaluate_der, count=1))
    want = jax_diar.calibrate_threshold(str(jax_copy), thresholds=[1.1], seed=10,
                                        tmp_dir=str(tmp_path / "j"))
    got = pt_diar.calibrate_threshold(str(embedding_bundle), thresholds=[1.1], seed=10,
                                      tmp_dir=str(tmp_path / "p"), device="cpu")
    assert got == want
    c_want = jax_diar.calibrate_single_cutoff(str(jax_copy), seed=2, count=1)
    c_got = pt_diar.calibrate_single_cutoff(str(embedding_bundle), seed=2, count=1, device="cpu")
    np.testing.assert_allclose(c_got, c_want, rtol=1e-4)
    assert json.loads((embedding_bundle / "calibration.json").read_text()).keys() == \
        json.loads((jax_copy / "calibration.json").read_text()).keys()

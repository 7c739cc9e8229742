"""The port's evaluation metrics held against the JAX package's: WER, DER
and the JSON comparison on seeded random transcripts and turns, and the
metrics CLI. Host code on both sides, so equal means equal (the same
floats)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from modular_audio_pipeline_tpu import evaluation as jax_eval
from modular_audio_pipeline_tpu_torch import evaluation as pt_eval

ROOT = Path(__file__).resolve().parents[1]
WORDS = ["alpha", "Beta,", "gamma!", "delta", "it's", "EPSILON", "zeta.", "eta", "theta?"]


def random_text(rng, n):
    return " ".join(rng.choice(WORDS, size=n))


def random_turns(rng, n, speakers):
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.uniform(0.0, 1.5))
        d = float(rng.uniform(0.2, 4.0))
        out.append((str(rng.choice(speakers)), round(t, 3), round(t + d, 3)))
        t += d * float(rng.uniform(0.3, 1.0))  # overlaps now and then
    return out


@pytest.mark.parametrize("seed", range(6))
def test_wer_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ref = random_text(rng, int(rng.integers(0, 30)))
    hyp = random_text(rng, int(rng.integers(0, 30)))
    assert pt_eval.wer(ref, hyp) == jax_eval.wer(ref, hyp)
    assert pt_eval.wer(ref, ref)["wer"] == 0.0 or not ref


@pytest.mark.parametrize("seed", range(6))
def test_der_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    ref = random_turns(rng, int(rng.integers(1, 12)), ["A", "B", "C"])
    hyp = random_turns(rng, int(rng.integers(0, 12)), ["SPEAKER_00", "SPEAKER_01"])
    assert pt_eval.der(ref, hyp) == jax_eval.der(ref, hyp)
    assert pt_eval.der(ref, hyp, resolution=0.05) == jax_eval.der(ref, hyp, resolution=0.05)


def test_empty_cases_equal_jax():
    for ref, hyp in (("", ""), ("", "a b"), ("a b", "")):
        assert pt_eval.wer(ref, hyp) == jax_eval.wer(ref, hyp)
    for ref, hyp in (([], []), ([], [("A", 0.0, 1.0)]), ([("A", 0.0, 1.0)], [])):
        assert pt_eval.der(ref, hyp) == jax_eval.der(ref, hyp)


def _write_docs(tmp_path, seed):
    rng = np.random.default_rng(200 + seed)
    paths = []
    for name in ("ref", "hyp"):
        turns = random_turns(rng, 8, ["SPEAKER_00", "SPEAKER_01", "SPEAKER_02"])
        segs = [{"speaker": s, "start": a, "end": b, "text": random_text(rng, 5)}
                for s, a, b in turns]
        if name == "hyp":
            for seg in segs[::3]:
                del seg["speaker"]  # read as SPEAKER_00, in both packages
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"metadata": {}, "segments": segs}))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("seed", range(3))
def test_compare_transcriptions_equals_jax(tmp_path, seed):
    ref, hyp = _write_docs(tmp_path, seed)
    assert pt_eval.compare_transcriptions(ref, hyp) == jax_eval.compare_transcriptions(ref, hyp)


def test_metrics_cli_prints_the_comparison(tmp_path):
    """``python -m modular_audio_pipeline_tpu_torch.evaluation.metrics REF
    HYP`` prints the JAX package's comparison as JSON."""
    ref, hyp = _write_docs(tmp_path, 0)
    out = subprocess.run(
        [sys.executable, "-m", "modular_audio_pipeline_tpu_torch.evaluation.metrics", ref, hyp],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == json.loads(
        json.dumps(jax_eval.compare_transcriptions(ref, hyp)))

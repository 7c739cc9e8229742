"""The port's decode-quality harnesses held against the JAX package's tools.

``evaluation.paired``, ``evaluation.longform`` and ``evaluation.crossfade``
build their data as ``tools/eval_tpu_paired.py``, ``tools/eval_longform.py``
and ``tools/eval_crossfade.py`` do: the held-out sentences, the long-form
streams (audio, truth, sentence starts) and the silence strips are equal
bit for bit at the tools' sizes. On the CPU, 4 held-out sentences decode to
the paired tool's hypotheses and WERs. The long-form and crossfade
harnesses are paired with their tools in
tests/test_torch_evaluation_longform.py and
tests/test_torch_evaluation_crossfade.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
from jax_eval_tool import two_torch_threads
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from torch_jax_native import load_jax_native

import modular_audio_pipeline_tpu.evaluation.metrics as jax_metrics
from modular_audio_pipeline_tpu_torch.evaluation import crossfade, longform, paired
from modular_audio_pipeline_tpu_torch.evaluation.metrics import wer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools import eval_crossfade, eval_longform, eval_tpu_paired  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The strips go through both packages' native crossfade; a process
    that lost the JAX library to a concurrent build would take numpy's."""
    assert load_jax_native() is not None


def assert_audio_equal(a: np.ndarray, b: np.ndarray):
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_held_out_sentences_equal_jax():
    (got, sr), (want, want_sr) = paired.build_eval_set(48), eval_tpu_paired.build_eval_set(48)
    assert sr == want_sr and len(got) == len(want) == 48
    for (text, audio), (want_text, want_audio) in zip(got, want):
        assert text == want_text
        assert_audio_equal(audio, want_audio)


@pytest.mark.parametrize("minutes,words", [(2.5, (8, 20)), (2.0, (12, 26))],
                         ids=["longform", "crossfade"])
def test_streams_equal_jax(minutes, words):
    """The long-form tool's stream (its main's word range) and the crossfade
    tool's (make_stream's defaults), each on its own seed."""
    seed = longform.SEED_STREAM if minutes == 2.5 else crossfade.SEED_CROSSFADE
    assert seed == (900_000 if minutes == 2.5 else 910_000)
    got = longform.make_stream(minutes, np.random.default_rng(seed), *words)
    want = eval_longform.make_stream(minutes, np.random.default_rng(seed), *words)
    assert_audio_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert len(got[0]) >= minutes * 60 * 16000
    if minutes == 2.0:
        for xf in (20, 0):
            assert_audio_equal(crossfade.strip_silence(got[0], 16000, xf),
                               eval_crossfade.strip_silence(want[0], 16000, xf))


def test_paired_decode_equals_jax():
    with two_torch_threads():
        refs, hyps = paired.decode_all(str(paired.BUNDLE), "cpu", 4)
    want_refs, want_hyps = eval_tpu_paired.decode_all(str(eval_tpu_paired.BUNDLE), True, "cpu", 4)
    assert refs == want_refs and hyps == want_hyps
    per = [wer(r, h)["wer"] for r, h in zip(refs, hyps)]
    assert per == [jax_metrics.wer(r, h)["wer"] for r, h in zip(refs, hyps)]
    # the summary with the tool's keys, on a second device's WERs
    other = [per[0] + 0.25, per[1], per[2] - 0.125, per[3]]
    d = paired.paired_deltas(other, per)
    assert set(d) == {"mean", "n_worse", "n_better", "n_equal", "max_abs", "per_sentence"}
    assert (d["n_worse"], d["n_better"], d["n_equal"], d["max_abs"]) == (1, 1, 2, 0.25)

"""The port's recorder (``runtime/tracing.py``) on the CPU.

With no recorder installed, a span and a counter touch no clock and make
nothing. Under a recorder, ``ServingPipeline.process`` (test-tiny, random
weights, the shipped VAD and diarization bundles) records its stages and
their parts as a tree, each child inside its parent, and counts one decode
step per single-token ``decoder_forward`` call; the result is the one an
unrecorded call gives. A train step records its forward, backward and
optimizer spans and computes the loss an unrecorded step computes.
"""

import time

import numpy as np
import pytest
import torch
from test_serving import make_audio
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu_torch.config import PipelineConfig
from modular_audio_pipeline_tpu_torch.models.whisper import decode
from modular_audio_pipeline_tpu_torch.models.whisper import model as pt_model
from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
from modular_audio_pipeline_tpu_torch.ops.attention import flash_attention
from modular_audio_pipeline_tpu_torch.runtime import integrity, tracing
from modular_audio_pipeline_tpu_torch.serving import ServingPipeline
from modular_audio_pipeline_tpu_torch.training import whisper_train

SR = 16000

# every span the serving path opens, under the span that holds it
SERVING_TREE = {
    "serving.process": None,
    "serving.dsp": "serving.process",
    "serving.vad": "serving.process",
    "serving.gather": "serving.process",
    "whisper": "serving.process",
    "whisper.encode": "whisper",
    "whisper.decode": "whisper",
    "whisper.fetch": "whisper",
    "whisper.words": "whisper",
    "words.matrix": "whisper.words",
    "words.dtw": "whisper.words",
    "words.backtrace": "whisper.words",
    "diarization": "serving.process",
    "diarization.segmentation": "diarization",
    "diarization.embedding": "diarization",
    "diarization.clustering": "diarization",
}


def test_the_off_path_reads_no_clock_and_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the off path touched a clock or made an event")

    monkeypatch.setattr(time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)

    @tracing.spanned("f")
    def f(x):
        return x + 1

    assert tracing.span("a") is tracing.span("b")  # one shared null context
    with tracing.span("a") as s:
        assert s is None
        tracing.count("c")
        tracing.count("c", 5)
        assert f(1) == 2
    assert getattr(tracing._local, "recorder", None) is None


def test_spans_nest_and_carry_counter_deltas(monkeypatch):
    monkeypatch.setattr(flash_attention, "launches", flash_attention.launches)
    monkeypatch.setitem(integrity.counts, "fetch", integrity.counts["fetch"])
    with tracing.record() as rec:
        with tracing.span("outer"):
            tracing.count("steps")
            with tracing.span("inner"):
                flash_attention.launches += 2
                integrity.counts["fetch"] += 1
                tracing.count("steps", 3)
            with tracing.span("inner"):
                pass
        with tracing.record() as nested:  # a recorder inside another takes the spans
            with tracing.span("apart"):
                tracing.count("steps")
        tracing.count("steps")
    names = [s.name for s in rec.spans]
    assert names == ["outer", "inner", "inner"]
    outer, inner, empty = rec.spans
    assert (outer.parent, inner.parent, empty.parent) == (-1, 0, 0)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= empty.start_ns <= outer.end_ns
    assert inner.counts == {"flash_attention": 2, "fetch": 1, "steps": 3}
    assert outer.counts == {"flash_attention": 2, "fetch": 1, "steps": 4}
    assert empty.counts == {}
    assert rec.counters == {"steps": 5}
    assert [s.name for s in nested.spans] == ["apart"] and nested.counters == {"steps": 1}
    assert rec.root(2) == 0 and rec.closed
    summary = rec.summary()
    assert summary["inner"]["spans"] == 2 and summary["outer"]["spans"] == 1
    assert summary["inner"]["counts"] == {"flash_attention": 2, "fetch": 1, "steps": 3}
    assert summary["outer"]["device_s"] is None  # no card: no device seconds
    assert getattr(tracing._local, "recorder", None) is None


def test_a_span_that_raises_is_closed():
    with tracing.record() as rec:
        with pytest.raises(ValueError):
            with tracing.span("failing"):
                raise ValueError("x")
        with tracing.span("after"):
            pass
    assert [(s.name, s.parent) for s in rec.spans] == [("failing", -1), ("after", -1)]
    assert all(s.end_ns >= s.start_ns for s in rec.spans)


@pytest.fixture(scope="module")
def tiny_pipeline():
    cfg = PipelineConfig()
    t = cfg.transcription
    t.model, t.weights_path, t.language, t.compute_type = "test-tiny", "random:0", "en", "float32"
    t.beam_size, t.max_decode_tokens, t.batch_size = 5, 24, 4
    t.word_timestamps = True
    t.no_speech_threshold = None  # every window is parsed and aligned
    return ServingPipeline(cfg, device="cpu")


def _result(r):
    segs = [(s["text"], s["start"], s["end"], s["confidence"],
             [(w["word"], w["start"], w["end"]) for w in s.get("words", [])])
            for s in r["segments"]]
    return segs, r["diarization"], r["kept_duration"], r["decode_stats"]


def test_process_records_the_span_tree_and_the_decode_steps(tiny_pipeline, monkeypatch):
    audio = np.round(make_audio(40.0, seed=2) * 32767).astype(np.int16)
    unrecorded = tiny_pipeline.process(audio, SR)

    real = decode.decoder_forward
    single = [0]

    def counting(params, dims, tokens, *a, **kw):
        single[0] += tokens.shape[1] == 1
        return real(params, dims, tokens, *a, **kw)

    monkeypatch.setattr(decode, "decoder_forward", counting)
    with tracing.record() as rec:
        recorded = tiny_pipeline.process(audio, SR)

    assert _result(recorded) == _result(unrecorded)
    assert recorded["segments"] and recorded["diarization"]
    assert any(s.get("words") for s in recorded["segments"])
    assert single[0] > 0 and rec.counters["decode.steps"] == single[0]

    seen = {s.name for s in rec.spans}
    assert seen == set(SERVING_TREE), seen ^ set(SERVING_TREE)
    for s in rec.spans:
        parent = rec.spans[s.parent] if s.parent >= 0 else None
        assert (parent.name if parent else None) == SERVING_TREE[s.name], s.name
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, s.name
    decodes = [s for s in rec.spans if s.name == "whisper.decode"]
    assert sum(s.counts["decode.steps"] for s in decodes) == single[0]
    summary = rec.summary()
    assert summary["serving.process"]["spans"] == 1
    assert summary["serving.process"]["counts"]["decode.steps"] == single[0]


def test_train_step_records_its_parts_and_the_same_loss():
    dims = WHISPER_DIMS["test-tiny"]
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(rng.standard_normal((2, dims.n_mels, 3000)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 400, (2, 16))).long()
    targets = torch.roll(tokens, -1, dims=1)
    targets[:, :3] = whisper_train.IGNORE_INDEX

    def one_step(recorded):
        params = pt_model.init_params(dims, torch.Generator().manual_seed(0), torch.float32)
        init_state, train_step = whisper_train.make_train_step(dims)
        state = init_state(params)
        if not recorded:
            return train_step(state, mel, tokens, targets)[1], None
        with tracing.record() as rec:
            loss = train_step(state, mel, tokens, targets)[1]
        return loss, rec

    plain, _ = one_step(False)
    loss, rec = one_step(True)
    assert torch.equal(loss, plain)
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("train.step", -1), ("train.forward", 0), ("train.backward", 0),
        ("train.optimizer", 0)]
    step = rec.spans[0]
    for s in rec.spans[1:]:
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns

"""The port's StreamingSession: chunked ingest equals the offline seek loop,
and equals the JAX package's session over the same chunks.

The five properties of tests/test_streaming.py, on the port's backend
(test-tiny with the JAX backend's random float32 weights carried across,
beam 1, 24 tokens, the no-speech gate off), then both packages' sessions
fed the same chunks: equal segments (text, start, end) and text, emitted
at the same feeds; confidences within 5e-4 (f32 sums in another order).
"""

import jax
import numpy as np
import pytest
import torch
from test_streaming import make_audio
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.streaming import StreamingSession as JaxSession
from modular_audio_pipeline_tpu.transcriber import JaxWhisperBackend
from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
from modular_audio_pipeline_tpu_torch.streaming import StreamingSession
from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend

SR = 16000
KW = dict(language="en", weights_path="random:0", beam_size=1, max_decode_tokens=24,
          chunking="sequential", word_timestamps=False, temperature_fallback=False,
          no_speech_threshold=None, compute_dtype="float32")


@pytest.fixture(scope="module")
def backends():
    jb = JaxWhisperBackend("test-tiny", **KW)
    jb.load()
    pb = TorchWhisperBackend("test-tiny", device="cpu", **KW)
    pb.load()
    pb.params = params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu", torch.float32)
    return jb, pb


@pytest.fixture(scope="module")
def backend(backends):
    return backends[1]


def key(segments):
    return [(s["text"], s["start"], s["end"]) for s in segments]


def test_matches_offline_sequential(backend):
    audio = make_audio(70.0)
    offline = backend.transcribe_array(audio, SR)

    session = StreamingSession(backend)
    streamed = []
    for start in range(0, len(audio), 7 * SR):  # awkward 7 s chunks
        streamed.extend(session.feed(audio[start : start + 7 * SR], SR))
    result = session.finish()

    assert result["text"] == offline["text"]
    assert key(result["segments"]) == key(offline["segments"])
    assert result["duration"] == pytest.approx(offline["duration"], abs=1e-3)
    # everything emitted mid-stream is a prefix of the final segments
    assert streamed == result["segments"][: len(streamed)]


def test_incremental_emission_before_finish(backend):
    audio = make_audio(70.0, seed=1)
    session = StreamingSession(backend)
    mid = []
    for start in range(0, len(audio), 10 * SR):
        mid.extend(session.feed(audio[start : start + 10 * SR], SR))
    assert mid, "expected segments finalized before finish()"
    session.finish()


def test_int16_and_resample_ingest(backend):
    audio = make_audio(35.0, seed=2)
    session = StreamingSession(backend)
    ref = StreamingSession(backend)
    as_int16 = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    for start in range(0, len(audio), 5 * SR):
        session.feed(as_int16[start : start + 5 * SR], SR)
        ref.feed(audio[start : start + 5 * SR], SR)
    got, want = session.finish(), ref.finish()
    assert got["text"] == want["text"]

    # 44.1 kHz chunks are resampled on the host before they are buffered
    from modular_audio_pipeline_tpu_torch.audio_io import resample_poly

    hi = resample_poly(audio[: 10 * SR], SR, 44100)  # under a window: nothing decodes yet
    resampled = StreamingSession(backend)
    assert resampled.feed(hi, 44100) == []
    assert resampled._buffered == len(resample_poly(hi, 44100, SR))
    resampled.finish()


def test_feed_after_finish_raises(backend):
    session = StreamingSession(backend)
    session.feed(make_audio(2.0), SR)
    session.finish()
    with pytest.raises(RuntimeError):
        session.feed(make_audio(1.0), SR)


def test_context_manager_flushes(backend):
    audio = make_audio(35.0, seed=3)
    with StreamingSession(backend) as session:
        session.feed(audio, SR)
    assert session._finished


@pytest.mark.parametrize("chunk_s, seed", [(7, 0), (10, 1), (31, 5)])
def test_streamed_segments_equal_jax_session(backends, chunk_s, seed):
    """Both packages' sessions over the same chunks: the same segments at
    the same feeds, and the same final result."""
    jb, pb = backends
    audio = make_audio(70.0, seed=seed)
    js, ps = JaxSession(jb), StreamingSession(pb)
    n = chunk_s * SR
    for start in range(0, len(audio), n):
        want = js.feed(audio[start : start + n], SR)
        got = ps.feed(audio[start : start + n], SR)
        assert key(got) == key(want)
    want, got = js.finish(), ps.finish()
    assert key(got["segments"]) == key(want["segments"]) and got["segments"]
    assert got["text"] == want["text"]
    assert (got["language"], got["duration"]) == (want["language"], want["duration"])
    np.testing.assert_allclose([s["confidence"] for s in got["segments"]],
                               [s["confidence"] for s in want["segments"]], rtol=0, atol=5e-4)


def test_auto_language_on_the_first_window(backends):
    """language="auto": the session detects the language from its first
    window's log-mel, as the JAX session does."""
    jb, pb = backends
    audio = make_audio(35.0, seed=7)
    js, ps = JaxSession(jb, language="auto"), StreamingSession(pb, language="auto")
    js.feed(audio, SR)
    ps.feed(audio, SR)
    want, got = js.finish(), ps.finish()
    assert got["language"] == want["language"]
    assert key(got["segments"]) == key(want["segments"])


def test_from_config_builds_a_session_on_the_device():
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.transcription.model = "test-tiny"
    cfg.transcription.language = "en"
    cfg.transcription.chunking = "sequential"
    session = StreamingSession.from_config(cfg, device="cpu")
    assert session.backend.chunking == "sequential"
    assert session.backend.device.type == "cpu" and session._language == "en"

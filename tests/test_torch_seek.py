"""The port's seek loop (``chunking="sequential"``) held against the JAX
package's, on the CPU.

Both backends decode test-tiny with the JAX backend's random float32
weights carried across (``params_from_numpy``), so the two decode the same
model. Equal means equal: tokens, segments (text, start, end), the seek
advances and the consumed text; the average log-probabilities (the
segments' confidences) agree to 5e-4, as in tests/test_torch_transcriber.py
(f32 sums in another order).

First the repair of positions past ``n_text_ctx``: once a window has a
previous text, the prompt is padded to 223 tokens and the prefix is 227
long (with a set language), so a window that decodes its 224-token budget
reaches positions 448-450. There the JAX package's positional row is zero (a one-hot product
over 448 rows) and its cache writes clamp to the last row
(``dynamic_update_slice``); the port must decode the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_streaming import make_audio
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from test_torch_transcriber import eval_sentences  # noqa: F401  (fixture)

from modular_audio_pipeline_tpu.models.whisper import decode as jax_decode
from modular_audio_pipeline_tpu.ops.mel import log_mel as jax_log_mel
from modular_audio_pipeline_tpu.transcriber import JaxWhisperBackend
from modular_audio_pipeline_tpu_torch.models.whisper import decode as pt_decode
from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
from modular_audio_pipeline_tpu_torch.ops.mel import log_mel as pt_log_mel
from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend
from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

SR = 16000
LP_TOL = 5e-4  # average log-probabilities: f32 sums in another order


def pair(tokens=24, beam=1, **kw):
    """(JAX backend, port backend) of test-tiny with random weights from
    seed 0, sequential chunking, the port holding the JAX weights."""
    common = dict(language="en", weights_path="random:0", beam_size=beam,
                  max_decode_tokens=tokens, chunking="sequential", word_timestamps=False,
                  temperature_fallback=False, no_speech_threshold=None, compute_dtype="float32")
    common.update(kw)
    jb = JaxWhisperBackend("test-tiny", **common)
    jb.load()
    pb = TorchWhisperBackend("test-tiny", device="cpu", **common)
    pb.load()
    pb.params = params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu", torch.float32)
    return jb, pb


def key(segments):
    return [(s["text"], s["start"], s["end"]) for s in segments]


def assert_same_result(got, want):
    assert key(got["segments"]) == key(want["segments"])
    assert got["text"] == want["text"]
    assert got["language"] == want["language"]
    assert got["duration"] == pytest.approx(want["duration"], abs=1e-9)
    np.testing.assert_allclose([s["confidence"] for s in got["segments"]],
                               [s["confidence"] for s in want["segments"]], rtol=0, atol=LP_TOL)


@pytest.fixture(scope="module")
def long_prompt_pair():
    return pair(tokens=224, beam=5, chunking="batched")  # decode_windows alone


@pytest.mark.parametrize("beam", [1, 5])
def test_decode_past_the_text_context_equals_jax(long_prompt_pair, monkeypatch, beam):
    """One window with a 223-token previous text and a 224-token budget:
    the decode reaches positions past 447 and gives the JAX package's
    tokens and average log-probability (beam 1 and beam 5, int8 KV cache,
    the ancestry route at beam 5)."""
    jb, pb = long_prompt_pair
    rng = np.random.default_rng(8)
    audio = make_audio(30.0, seed=5)
    prompt = [int(t) for t in rng.integers(0, pb.tokenizer.eot, size=223)]  # text tokens
    opts_j = jax_decode.DecodeOptions(language="en", beam_size=beam, max_tokens=224,
                                      prompt_tokens=tuple(prompt))
    opts_p = pt_decode.DecodeOptions(language="en", beam_size=beam, max_tokens=224,
                                     prompt_tokens=tuple(prompt))
    want = jax_decode.decode_windows(jb.params, jb.dims, jb.tokenizer,
                                     jax_log_mel(jnp.asarray(audio[None])), opts_j)

    reached = []
    real = pt_decode.decoder_forward

    def spy(params, dims, tokens, *a, **k):
        reached.append(a[2].pos + tokens.shape[1] - 1)
        return real(params, dims, tokens, *a, **k)

    monkeypatch.setattr(pt_decode, "decoder_forward", spy)
    got = pt_decode.decode_windows(pb.params, pb.dims, pb.tokenizer,
                                   pt_log_mel(torch.from_numpy(audio[None])), opts_p)
    assert max(reached) > 447, max(reached)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.avg_logprobs, np.asarray(want.avg_logprobs),
                               rtol=0, atol=LP_TOL)
    np.testing.assert_allclose(got.no_speech_probs, np.asarray(want.no_speech_probs),
                               rtol=1e-4, atol=1e-6)


def test_positions_past_the_table_get_a_zero_row():
    """decoder_forward's positional rows: the table's rows up to 447 and
    zeros past it, as the JAX one-hot product gives them."""
    from modular_audio_pipeline_tpu_torch.models.whisper.model import _pos_rows

    table = torch.arange(448 * 3, dtype=torch.float32).reshape(448, 3)
    torch.testing.assert_close(_pos_rows(table, 440, 8), table[440:448])
    rows = _pos_rows(table, 445, 6)
    torch.testing.assert_close(rows[:3], table[445:448])
    assert torch.count_nonzero(rows[3:]) == 0
    assert torch.count_nonzero(_pos_rows(table, 450, 1)) == 0


@pytest.fixture(scope="module")
def parse_pair():
    return pair()


def _rows(tok):
    ts = lambda sec: tok.timestamp_begin + int(round(sec / 0.02))  # noqa: E731
    a, b, c, d, e = 300, 301, 302, 303, 304
    return {
        "pairs_then_open": ([ts(0), a, b, ts(5), ts(5), c, d, ts(8), ts(8), e, tok.eot], 30.0),
        "pairs_then_single": ([ts(0), a, ts(5), ts(5), b, ts(9), tok.eot], 30.0),
        "single_trailing": ([ts(0), a, b, ts(9), tok.eot], 30.0),
        "no_completed_pair": ([ts(0), a, b, tok.eot], 30.0),
        "no_pair_open_timestamp": ([ts(1), a, b, ts(4), c], 30.0),
        "start_past_window": ([ts(0), a, ts(4), ts(6), b, ts(7), ts(7), c, tok.eot], 5.0),
        "empty": ([tok.eot, tok.eot], 30.0),
    }


@pytest.mark.parametrize("case", ["pairs_then_open", "pairs_then_single", "single_trailing",
                                  "no_completed_pair", "no_pair_open_timestamp",
                                  "start_past_window", "empty"])
def test_parse_window_seek_equals_jax(parse_pair, case):
    jb, pb = parse_pair
    row, win_dur = _rows(pb.tokenizer)[case]
    assert row == _rows(jb.tokenizer)[case][0]
    want = jb._parse_window_seek(np.asarray(row, np.int32), -0.5, 12.0, win_dur)
    got = pb._parse_window_seek(np.asarray(row, np.int32), -0.5, 12.0, win_dur)
    assert got == want
    if case == "empty":
        assert got == ([], win_dur, [])


LOOP_CASES = {
    "beam1": dict(beam=1),
    "beam5": dict(beam=5),
    "beam5_no_condition": dict(beam=5, condition_on_previous_text=False),
    "beam1_no_condition": dict(beam=1, condition_on_previous_text=False),
    "beam5_gate_on": dict(beam=5, no_speech_threshold=1e-9, logprob_threshold=-1.0),
    "beam1_gate_on_passes": dict(beam=1, no_speech_threshold=0.6, logprob_threshold=-1.0),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_seek_loop_equals_jax(case):
    """70 s of voiced audio (tests/test_streaming.py's), 24-token budget:
    equal segments, text and windows. ``gate_on`` with a threshold no
    window passes skips every window whole; with whisper's 0.6 none is
    skipped (random weights give a tiny no-speech probability)."""
    kw = dict(LOOP_CASES[case])
    beam = kw.pop("beam")
    cond = kw.pop("condition_on_previous_text", True)
    jb, pb = pair(beam=beam, **kw)
    jb.condition_on_previous_text = pb.condition_on_previous_text = cond
    audio = make_audio(70.0)
    steps = {"jax": [], "port": []}
    for name, b in (("jax", jb), ("port", pb)):
        real = b.seek_decode_step

        def spy(chunk, seek, opts, all_tokens, _real=real, _name=name):
            out = _real(chunk, seek, opts, all_tokens)
            steps[_name].append((seek, out[1], list(out[2])))
            return out

        b.seek_decode_step = spy
    want = jb.transcribe_array(audio, SR)
    got = pb.transcribe_array(audio, SR)
    assert_same_result(got, want)
    assert steps["port"] == steps["jax"]
    assert len(steps["port"]) >= 3
    assert pb.last_stats["windows"] == len(steps["port"])
    if case == "beam5_gate_on":
        assert got["segments"] == [] and all(s[1] == min(480000, len(audio) - s[0])
                                             for s in steps["port"])
    else:
        assert got["segments"]


def test_seek_loop_ladder_equals_jax(monkeypatch):
    """The temperature ladder inside the seek step: a window whose average
    log-probability is below the threshold goes up the ladder in both
    packages. Samples cannot be equal across packages (another
    generator, ROADMAP.md §C), so both packages' rungs are bound to the
    same greedy decode; the windows sent up the ladder, the tokens taken
    from it and the segments must then be equal."""
    jb, pb = pair(beam=5)
    for b in (jb, pb):
        b.temperature_fallback = True
        b.logprob_threshold = -1.0  # random weights: every window fails the gate
    calls = {"jax": [], "port": []}

    def greedy_rungs(name, backend, decode_windows):
        def retry(mel, failing, opts):
            calls[name].append(list(failing))
            from dataclasses import replace
            res = decode_windows(backend.params, backend.dims, backend.tokenizer, mel,
                                 replace(opts, beam_size=1))
            return {i: (res.tokens[i], float(res.avg_logprobs[i])) for i in failing}
        return retry

    monkeypatch.setattr(jb, "_retry_windows", greedy_rungs("jax", jb, jax_decode.decode_windows))
    monkeypatch.setattr(pb, "_retry_windows", greedy_rungs("port", pb, pt_decode.decode_windows))
    audio = make_audio(70.0, seed=4)
    want = jb.transcribe_array(audio, SR)
    got = pb.transcribe_array(audio, SR)
    assert calls["port"] == calls["jax"] and calls["port"]
    assert pb.last_stats["retried_windows"] == len(calls["port"])
    assert_same_result(got, want)


def test_proxy_sentences_sequential_equal_jax(eval_sentences):  # noqa: F811
    """The trained proxy bundle's held-out sentences through both
    WhisperTranscribers with chunking="sequential" (float32, beam 5, 128
    tokens): equal segments and text."""
    from modular_audio_pipeline_tpu.transcriber import WhisperTranscriber as JaxTranscriber
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    kw = dict(model_name="tiny", language="en", beam_size=5,
              weights_path=str(SHIPPED_WEIGHTS / "whisper-tiny-synth-proxy"),
              word_timestamps=False, max_decode_tokens=128, chunking="sequential")
    jax_tr = JaxTranscriber(**kw)
    jax_tr._backend.compute_dtype = "float32"
    pt_tr = WhisperTranscriber(**kw, device="cpu")
    pt_tr._backend.compute_dtype = "float32"
    for path in eval_sentences:
        want = jax_tr.transcribe(path)
        got = pt_tr.transcribe(path)
        assert got["segments"], path
        assert all("words" not in s for s in got["segments"])  # none, as in JAX
        assert_same_result(got, want)


def test_device_buffer_takes_the_host_path_when_sequential():
    """transcribe_buffer with a padded tensor: the seek loop reads the
    valid samples on the host, so the result equals transcribe_array's."""
    from modular_audio_pipeline_tpu_torch.audio_io import AudioBuffer

    _, pb = pair()
    audio = make_audio(40.0, seed=6)
    padded = np.zeros(2 * 480000, np.float32)
    padded[: len(audio)] = audio
    from_buffer = pb.transcribe_buffer(
        AudioBuffer(sr=SR, n_valid=len(audio), tensor=torch.from_numpy(padded)))
    assert from_buffer == pb.transcribe_array(audio, SR)

"""The port's word-timestamp alignment held against the JAX package's.

Seeded numpy inputs go through both packages on the CPU in float32: the
median network, the batched DTW (also against the scalar oracle), the
alignment matrix at test-tiny, and the words of the trained proxy bundle
on its held-out sentences.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_audio_pipeline_tpu.models.whisper import decode as jax_decode
from modular_audio_pipeline_tpu.models.whisper import timestamps as jax_ts
from modular_audio_pipeline_tpu.models.whisper.config import WHISPER_DIMS
from modular_audio_pipeline_tpu.models.whisper.tokenizer import load_tokenizer as jax_tok
from modular_audio_pipeline_tpu_torch.models.whisper import decode as pt_decode
from modular_audio_pipeline_tpu_torch.models.whisper import timestamps as pt_ts
from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS as PT_DIMS
from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params, params_from_numpy
from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer as pt_tok
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
BUNDLE = ROOT / "modular_audio_pipeline_tpu/weights/whisper-tiny-synth-proxy"
DIMS = WHISPER_DIMS["test-tiny"]
PT = PT_DIMS["test-tiny"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["f32", "f16"])
def test_median7_equals_numpy_median(dtype):
    rng = np.random.default_rng(20)
    x = rng.standard_normal((7, 5, 33)).astype(np.float32)
    x[:, 0, :4] = 1.0  # ties
    t = torch.from_numpy(x).to(dtype)
    got = pt_ts._median7(list(t))
    assert got.dtype == dtype
    # a median of 7 is one of the inputs: exact in either type
    np.testing.assert_array_equal(got.float().numpy(), np.median(t.float().numpy(), axis=0))
    want = jax_ts._median7([jnp.asarray(v) for v in t.float().numpy()])
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


def test_median_filter_and_scalar_dtw_equal_jax():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 40))
    np.testing.assert_array_equal(pt_ts._median_filter(x), jax_ts._median_filter(x))
    cost = rng.standard_normal((9, 31)).astype(np.float32)
    np.testing.assert_array_equal(pt_ts.dtw_path_python(cost), jax_ts.dtw_path_python(cost))
    assert pt_ts.dtw_path is pt_ts.dtw_path_python


@pytest.mark.parametrize("b, s, t, lens", [
    (3, 12, 40, [12, 7, 0]), (2, 20, 9, [20, 3]), (1, 1, 1, [1]), (4, 6, 50, [6, 1, 5, 2]),
], ids=["ragged", "more_rows_than_frames", "single_cell", "short_rows"])
def test_dtw_cols_batched_equals_jax_and_the_scalar_oracle(b, s, t, lens):
    rng = np.random.default_rng(22)
    cost = rng.standard_normal((b, s, t)).astype(np.float32)
    cost[0, :, : t // 2] = 0.25  # a plateau of exact ties: diagonal > up > left
    got = pt_ts.dtw_cols_batched(torch.from_numpy(cost), lens)
    assert got.shape == (b, s) and got.dtype == np.int32
    want = np.asarray(jax_ts.dtw_cols_batched(jnp.asarray(cost), jnp.asarray(lens, jnp.int32)))
    # integer paths through the same f32 accumulations: equal
    np.testing.assert_array_equal(got, want)
    for i, n in enumerate(lens):
        if n:
            np.testing.assert_array_equal(got[i, :n], pt_ts.dtw_path_python(cost[i, :n]))
        assert (got[i, n:] == 0).all()


@pytest.fixture(scope="module")
def tiny():
    tree = numpy_params(DIMS, seed=23)
    mel = np.random.default_rng(24).standard_normal((2, DIMS.n_mels, 3000)).astype(np.float32)
    jp, pp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu", torch.float32)
    jkv = jax_decode.encode_audio_kv(jp, DIMS, jnp.asarray(mel))
    pkv = pt_decode.encode_audio_kv(pp, PT, torch.from_numpy(mel))
    seq = np.random.default_rng(25).integers(0, 50000, (2, 64)).astype(np.int32)
    return jp, pp, jkv, pkv, seq


def test_alignment_matrix_matches_jax(tiny):
    jp, pp, jkv, pkv, seq = tiny
    want = np.asarray(jax_ts._alignment_matrix_impl(jp, jnp.asarray(seq), *jkv, DIMS))
    got = pt_ts._alignment_matrix_impl(pp, torch.from_numpy(seq).long(), *pkv, PT)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64, 1500)
    # standardised values of magnitude ~1 pass through f16 twice (the
    # probabilities, then the standardised values: 2^-11 relative each); a
    # value that the two packages round to neighbouring f16 numbers moves a
    # median by one f16 step (up to 4e-3 at |x| in [4, 8)) before the mean
    # over the 2 heads of test-tiny's top layer
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-3)
    assert np.abs(got.numpy() - want).mean() < 1e-4


def test_align_dtw_columns_match_jax(tiny):
    """Alignment + DTW end to end at test-tiny: the columns of both
    packages, equal or a frame apart where a near-tie in the cost flips a
    move (random weights give flat attention, the hardest case)."""
    jp, pp, jkv, pkv, seq = tiny
    lens = [60, 41]
    run = jax_ts._align_dtw_jit(DIMS, 4, 1500)
    want = np.asarray(run(jp, jnp.asarray(seq), *jkv, jnp.asarray(lens, jnp.int32)))
    got = pt_ts._align_dtw(pp, PT, torch.from_numpy(seq).long(), *pkv, lens, 4, 1500)
    assert got.shape == want.shape == (2, 60)
    for i, n in enumerate(lens):
        assert (np.diff(got[i, :n]) >= 0).all()  # monotonic in time
        assert (got[i, :n] == want[i, :n]).mean() >= 0.9


@pytest.fixture(scope="module")
def proxy():
    """The trained proxy bundle in float32 in both packages, with the audio
    K/V of its two held-out sentences and their beam-5 tokens."""
    from modular_audio_pipeline_tpu.ops.mel import log_mel
    from modular_audio_pipeline_tpu.training.synth_asr import VOCAB, synth_sentence

    dims_j, dims_p = WHISPER_DIMS["tiny"], PT_DIMS["tiny"]
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), load_params(str(BUNDLE)))
    jp, pp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu", torch.float32)
    rng = np.random.default_rng(500_000)
    audio = np.zeros((2, 480000), np.float32)
    for i in range(2):
        words = rng.integers(0, len(VOCAB), size=int(rng.integers(12, 27)))
        sig = synth_sentence(list(words), rng)
        audio[i, : len(sig)] = sig
    mel = np.asarray(log_mel(jnp.asarray(audio), n_mels=dims_j.n_mels))
    jkv = jax_decode.encode_audio_kv(jp, dims_j, jnp.asarray(mel))
    pkv = pt_decode.encode_audio_kv(pp, dims_p, torch.from_numpy(mel))
    tok = pt_tok(str(BUNDLE), dims_p.n_vocab)
    opts = pt_decode.DecodeOptions(language="en", beam_size=5, max_tokens=128)
    tokens = pt_decode.decode_windows(pp, dims_p, tok, None, opts, audio_kv=pkv).tokens
    prefix, _ = pt_decode.build_initial_tokens(tok, opts)
    return jp, pp, jkv, pkv, tokens, prefix


def test_align_words_batched_words_equal_jax_on_the_proxy_bundle(proxy):
    jp, pp, jkv, pkv, tokens, prefix = proxy
    dims_j, dims_p = WHISPER_DIMS["tiny"], PT_DIMS["tiny"]
    items = [(i, [int(t) for t in tokens[i]], prefix) for i in range(2)]
    want = jax_ts.align_words_batched(jp, dims_j, jax_tok(str(BUNDLE), dims_j.n_vocab),
                                      *jkv, items)
    got = pt_ts.align_words_batched(pp, dims_p, pt_tok(str(BUNDLE), dims_p.n_vocab),
                                    *pkv, items)
    assert len(got) == 2 and all(len(w) >= 10 for w in got)
    # trained attention is peaked, so no near-tie flips a DTW move: equal
    assert got == want
    # a window picked out of order and a single window select the same rows
    swapped = pt_ts.align_words_batched(pp, dims_p, pt_tok(str(BUNDLE), dims_p.n_vocab),
                                        *pkv, [items[1], items[0]])
    assert swapped == [got[1], got[0]]
    one = pt_ts.align_words(pp, dims_p, pt_tok(str(BUNDLE), dims_p.n_vocab),
                            pkv[0][:, 1:2], pkv[1][:, 1:2], items[1][1], prefix)
    assert one == got[1]


def test_align_words_handles_empty_input(proxy):
    _, pp, _, pkv, _, prefix = proxy
    tok = pt_tok(str(BUNDLE), PT_DIMS["tiny"].n_vocab)
    assert pt_ts.align_words_batched(pp, PT_DIMS["tiny"], tok, *pkv, []) == []
    assert pt_ts.align_words(pp, PT_DIMS["tiny"], tok, *pkv, [tok.eot] * 4, prefix) == []
    ts_only = [tok.timestamp_begin, tok.timestamp_begin + 5, tok.eot]
    assert pt_ts.align_words_batched(pp, PT_DIMS["tiny"], tok, *pkv, [(0, ts_only, prefix)]) == [[]]


def test_group_words_equals_jax():
    tok_p, tok_j = pt_tok(None, DIMS.n_vocab), jax_tok(None, DIMS.n_vocab)
    ts = tok_p.timestamp_begin
    tokens = [ts, 100, 200, 300, ts + 40, ts + 40, 400, 500, ts + 90, tok_p.eot, tok_p.eot]
    cols = np.array([0, 3, 3, 20, 41, 41, 50, 77, 90], np.int32)
    got = pt_ts._words_from_cols(cols, tokens, [1, 2], tok_p)
    assert got == jax_ts._words_from_cols(cols, tokens, [1, 2], tok_j)
    assert len(got) == 4 and got[0]["start"] == 0.06 and got[-1]["end"] == 1.8

"""PyTorch beam/greedy decoding held against the JAX package.

The same numpy-seeded test-tiny weights and mel windows go through both
``decode_windows`` in float32 on the CPU, with the int8 KV cache. The
outputs that drive everything downstream, the tokens, must be equal;
summed log-probabilities agree to 1e-4 (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_audio_pipeline_tpu.models.whisper import decode as jax_decode
from modular_audio_pipeline_tpu.models.whisper.config import WHISPER_DIMS
from modular_audio_pipeline_tpu.models.whisper.tokenizer import load_tokenizer as jax_tok
from modular_audio_pipeline_tpu_torch.models.whisper import decode as pt_decode
from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS as PT_DIMS
from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer as pt_tok
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401  (autouse)

DIMS = WHISPER_DIMS["test-tiny"]
PT = PT_DIMS["test-tiny"]


@pytest.mark.parametrize("max_new", [1, 32, 63, 64, 224, 440])
@pytest.mark.parametrize("p", [1, 4, 60, 63, 64, 200])
def test_stage_bounds_identical(p, max_new):
    assert pt_decode._stage_bounds(p, max_new, 448) == jax_decode._stage_bounds(p, max_new, 448)


def test_timestamp_rules_match_jax():
    """Every rule state (text, single and paired timestamps, first step)
    on the same log-probabilities."""
    tok = pt_tok(None, DIMS.n_vocab)
    ts, eot = tok.timestamp_begin, tok.eot
    rng = np.random.default_rng(4)
    lp = np.log(rng.dirichlet(np.ones(DIMS.n_vocab), size=6)).astype(np.float32)
    last = np.array([100, ts + 5, ts + 9, 200, ts, ts + 3], np.int32)
    penult = np.array([ts, 300, ts + 7, ts + 1, ts, ts + 3], np.int32)
    max_ts = np.array([0, ts + 5, ts + 9, ts + 30, ts, ts + 3], np.int32)
    for step in (0, 3):
        want = jax_decode._apply_timestamp_rules(
            jnp.asarray(lp), jnp.asarray(last), jnp.asarray(penult), jnp.asarray(max_ts),
            jnp.asarray(step), ts, eot, ts + 50)
        got = pt_decode._apply_timestamp_rules(
            torch.from_numpy(lp), torch.from_numpy(last).long(), torch.from_numpy(penult).long(),
            torch.from_numpy(max_ts).long(), step, ts, eot, ts + 50)
        # the same masks added in the same order; only logsumexp's
        # implementation differs, which can flip no rule here
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def setup():
    tree = numpy_params(DIMS, seed=5)
    mel = np.random.default_rng(6).standard_normal((2, DIMS.n_mels, 3000)).astype(np.float32)
    return (jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu", torch.float32),
            mel)


@pytest.mark.parametrize(
    "beam_size, ancestry",
    [(5, True), (5, False), (1, True)],
    ids=["beam5_ancestry", "beam5_physical_reorder", "greedy"],
)
def test_decode_windows_tokens_equal_jax(setup, beam_size, ancestry):
    jp, pp, mel = setup
    kw = dict(language="en", beam_size=beam_size, max_tokens=32, kv_int8=True,
              ancestry=ancestry)
    want = jax_decode.decode_windows(
        jp, DIMS, jax_tok(None, DIMS.n_vocab), jnp.asarray(mel), jax_decode.DecodeOptions(**kw))
    got = pt_decode.decode_windows(
        pp, PT, pt_tok(None, PT.n_vocab), torch.from_numpy(mel), pt_decode.DecodeOptions(**kw))
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert (got.lengths > 0).all()
    np.testing.assert_allclose(got.sum_logprobs, want.sum_logprobs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.no_speech_probs, want.no_speech_probs, rtol=1e-5, atol=1e-7)


def _sampling_run(pp, mel, seed, temperature=0.6, beam_size=1):
    opts = pt_decode.DecodeOptions(language="en", beam_size=beam_size, max_tokens=24,
                                   temperature=temperature)
    rng = None if seed is None else torch.Generator().manual_seed(seed)
    return pt_decode.decode_windows(pp, PT, pt_tok(None, PT.n_vocab), torch.from_numpy(mel),
                                    opts, rng=rng)


def test_sampling_is_reproducible_per_seed(setup):
    """temperature > 0: the same generator seed gives the same tokens twice,
    another seed gives others, no generator means seed 0; a beam size is
    ignored (sampling decodes one hypothesis per window)."""
    _, pp, mel = setup
    a, b, c = (_sampling_run(pp, mel, s) for s in (1234, 1234, 99))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.sum_logprobs, b.sum_logprobs)
    assert (a.tokens != c.tokens).any()
    np.testing.assert_array_equal(_sampling_run(pp, mel, None).tokens,
                                  _sampling_run(pp, mel, 0).tokens)
    beam = _sampling_run(pp, mel, 1234, beam_size=5)
    np.testing.assert_array_equal(beam.tokens, a.tokens)
    greedy = _sampling_run(pp, mel, 1234, temperature=0.0)
    assert (a.tokens != greedy.tokens).any()


def test_sampling_accounts_logprobs_from_the_unscaled_distribution(setup, monkeypatch):
    """The sampler receives softmax(lp / T) of the filtered
    log-probabilities, and sum_logprob adds the drawn token's UNscaled lp
    (JAX decode.py:370-378): recomputed here from what the sampler saw."""
    _, pp, mel = setup
    temperature = 0.5
    seen = []
    real = torch.multinomial

    def spy(probs, n, generator=None):
        out = real(probs, n, generator=generator)
        seen.append((probs.clone(), out[:, 0].clone()))
        return out

    monkeypatch.setattr(torch, "multinomial", spy)
    res = _sampling_run(pp, mel, 7, temperature=temperature)
    monkeypatch.undo()
    assert len(seen) == 24  # random weights never emit EOT inside the budget
    tok = pt_tok(None, PT.n_vocab)
    for step, (probs, drawn) in enumerate(seen):
        np.testing.assert_array_equal(drawn.numpy(), res.tokens[:, step])
        assert float(probs[:, tok.sot].max()) == 0.0  # suppressed specials stay unreachable
        np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    # scoring the drawn tokens with the temperature-free filtered
    # log-probabilities reproduces sum_logprob (f32 sums of 24 terms)
    np.testing.assert_allclose(res.sum_logprobs, _score_tokens(pp, mel, res.tokens),
                               rtol=0, atol=1e-3)


def _score_tokens(pp, mel, tokens):
    """Sum of filtered log-probabilities of ``tokens`` under the decoder,
    step by step, with the decode loop's own filter."""
    tok = pt_tok(None, PT.n_vocab)
    opts = pt_decode.DecodeOptions(language="en", beam_size=1, max_tokens=tokens.shape[1])
    xa_k, xa_v = pt_decode.encode_audio_kv(pp, PT, torch.from_numpy(mel))
    xa_k, xa_v = pt_decode._quantize_cross_kv(xa_k, xa_v)
    initial, sot_index = pt_decode.build_initial_tokens(tok, opts)
    suppress, blank = pt_decode._build_filter_tables(tok, opts, PT.n_vocab, "cpu")
    o = {"max_tokens": tokens.shape[1], "eot": tok.eot, "ts_begin": tok.timestamp_begin,
         "no_speech": tok.no_speech, "timestamps": True, "suppress_blank": True,
         "max_initial_ts_tok": tok.timestamp_begin + 50, "kv_int8": True}
    init = torch.tensor(initial)[None].expand(tokens.shape[0], -1)
    st, _ = pt_decode._greedy_prefill(pp, PT, xa_k, xa_v, init, sot_index, o, 64)
    total = torch.zeros(tokens.shape[0])
    for i in range(tokens.shape[1]):
        lp = pt_decode._filtered_logprobs(st["prev_logits"], i, st["last"], st["penult"],
                                          st["max_ts"], suppress, blank, o)
        nxt = torch.from_numpy(tokens[:, i].astype(np.int64))
        total += lp.gather(1, nxt[:, None])[:, 0]
        st["max_ts"] = torch.where(nxt >= o["ts_begin"], torch.maximum(st["max_ts"], nxt),
                                   st["max_ts"])
        st["penult"] = torch.full_like(st["last"], o["ts_begin"]) if i == 0 else st["last"]
        st["last"] = nxt
        logits, st["cache"] = pt_decode.decoder_forward(pp, PT, nxt[:, None], xa_k, xa_v,
                                                        st["cache"])
        st["prev_logits"] = logits[:, -1]
    return total.numpy()


def test_filtered_logprobs_the_sampler_receives_match_jax(setup):
    """The deterministic half of a sampling step: the filtered
    log-probabilities of the first step, which JAX hands to
    ``categorical(lp / T)`` and the port to ``multinomial(softmax(lp / T))``."""
    jp, pp, mel = setup
    tok = pt_tok(None, PT.n_vocab)
    opts = pt_decode.DecodeOptions(language="en", beam_size=1, max_tokens=8)
    initial, sot_index = pt_decode.build_initial_tokens(tok, opts)
    o = {"max_tokens": 8, "eot": tok.eot, "ts_begin": tok.timestamp_begin,
         "no_speech": tok.no_speech, "timestamps": True, "suppress_blank": True,
         "max_initial_ts_tok": tok.timestamp_begin + 50, "kv_int8": True, "temperature": 0.4,
         "beam_size": 1, "pool_size": 1, "ancestry": True}
    pkv = pt_decode._quantize_cross_kv(*pt_decode.encode_audio_kv(pp, PT, torch.from_numpy(mel)))
    init = torch.tensor(initial)[None].expand(2, -1)
    st, _ = pt_decode._greedy_prefill(pp, PT, *pkv, init, sot_index, o, 64)
    suppress, blank = pt_decode._build_filter_tables(tok, opts, PT.n_vocab, "cpu")
    got = pt_decode._filtered_logprobs(st["prev_logits"], 0, st["last"], st["penult"],
                                       st["max_ts"], suppress, blank, o)

    jkv = jax_decode._quantize_cross_kv(*jax_decode.encode_audio_kv(jp, DIMS, jnp.asarray(mel)))
    jstate, _ = jax_decode._greedy_prefill(
        jp, DIMS, *jkv, jnp.asarray(np.asarray(init), jnp.int32), sot_index, o,
        jax.random.PRNGKey(0), 64)
    jsup, jblank = jax_decode._build_filter_tables(jax_tok(None, DIMS.n_vocab),
                                                   jax_decode.DecodeOptions(**{
                                                       "language": "en", "beam_size": 1,
                                                       "max_tokens": 8}), DIMS.n_vocab)
    prev_logits = jstate[-1]
    lp = jax.nn.log_softmax(prev_logits, axis=-1)
    lp = jnp.where(jsup[None, :] > 0, -1e9, lp)
    lp = jnp.where(jblank[None, :] > 0, -1e9, lp)
    want = jax_decode._apply_timestamp_rules(lp, jstate[3], jstate[4], jstate[5], jnp.asarray(0),
                                             tok.timestamp_begin, tok.eot,
                                             tok.timestamp_begin + 50)
    # f32 logits that agree to 1e-4 (summation order), same masks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-4)
    assert (got.numpy() > -1e8).sum() == (np.asarray(want) > -1e8).sum()


def test_detect_language_matches_jax(setup):
    jp, pp, mel = setup
    lang_j, probs_j = jax_decode.detect_language(jp, DIMS, jax_tok(None, DIMS.n_vocab),
                                                 jnp.asarray(mel))
    lang_p, probs_p = pt_decode.detect_language(pp, PT, pt_tok(None, PT.n_vocab),
                                                torch.from_numpy(mel))
    assert lang_p == lang_j
    assert list(probs_p) == list(probs_j) and len(probs_p) == pt_tok(None, PT.n_vocab).special.n_languages
    # a softmax over ~100 logits that agree to 1e-4
    np.testing.assert_allclose(list(probs_p.values()), list(probs_j.values()), rtol=1e-3, atol=1e-7)
    assert abs(sum(probs_p.values()) - 1.0) < 1e-5

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

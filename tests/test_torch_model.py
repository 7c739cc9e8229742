"""PyTorch Whisper model functions held against the JAX package.

Same random weights (numpy, from a seed) at test-tiny dims go through
``params_from_numpy`` into the port and as jnp arrays into the JAX
functions; both run in float32 on the CPU (JAX's CPU backend rejects
batched bf16 products). Logits agree to 1e-4: the two sum the same f32
products in different orders through 2+2 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_audio_pipeline_tpu.models.whisper import decode as jax_decode
from modular_audio_pipeline_tpu.models.whisper import model as jax_model
from modular_audio_pipeline_tpu.models.whisper.config import WHISPER_DIMS
from modular_audio_pipeline_tpu_torch.models.whisper import decode as pt_decode
from modular_audio_pipeline_tpu_torch.models.whisper import model as pt_model
from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS as PT_DIMS
from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the port's tests run: the suite runs
    several pytest workers on the same cores, and torch's default of one
    thread per core oversubscribes them (spinning thread pools then slow
    every worker). Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


DIMS = WHISPER_DIMS["test-tiny"]
PT = PT_DIMS["test-tiny"]
TOL = dict(rtol=1e-4, atol=1e-4)


def numpy_params(dims, seed=0):
    """Random weights in the checkpoint tree layout, from numpy: shapes
    from the JAX init, values from ``default_rng(seed)``; biases and layer
    norms are non-trivial so every term is exercised."""
    shapes = jax.eval_shape(lambda: jax_model.init_params(dims, 0, jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "g":
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "pos_emb":
            v = 0.01 * rng.standard_normal(leaf.shape)
        elif name == "b" or name.endswith("_b"):
            v = 0.02 * rng.standard_normal(leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) * leaf.shape[-2] ** -0.5
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def weights():
    tree = numpy_params(DIMS)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu", torch.float32)


@pytest.fixture(scope="module")
def audio_kv(weights):
    jp, pp = weights
    mel = np.random.default_rng(1).standard_normal((2, DIMS.n_mels, 3000)).astype(np.float32)
    xa_j = jax_model.encoder_forward(jp, DIMS, jnp.asarray(mel))
    xa_p = pt_model.encoder_forward(pp, PT, torch.from_numpy(mel))
    return xa_j, xa_p


def test_encoder_and_cross_kv_match_jax(weights, audio_kv):
    jp, pp = weights
    xa_j, xa_p = audio_kv
    assert tuple(xa_p.shape) == (2, 1500, DIMS.n_audio_state)
    np.testing.assert_allclose(xa_p.numpy(), np.asarray(xa_j), **TOL)
    for got, want in zip(pt_model.cross_kv(pp, PT, xa_p), jax_model.cross_kv(jp, DIMS, xa_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _assert_codes_close(got, want):
    """int8 codes of values that agree to ~1e-6 may round to neighbouring
    codes where a value sits on a rounding boundary: at least 99.9% equal,
    never more than one code apart."""
    got, want = got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.999


def _compare_cache(pc, jc, quant):
    if quant:
        _assert_codes_close(pc.k, jc.k)
        _assert_codes_close(pc.v, jc.v)
        # scales are amax/127 of K/V rows: exact functions of rows that, in
        # layers above the first, carry the f32 summation-order drift of the
        # layers below (measured up to 4e-6 relative), hence 1e-5 there
        for l in range(pc.k.shape[0]):
            rtol = 1e-6 if l == 0 else 1e-5
            for mine, theirs in ((pc.k_scale, jc.k_scale), (pc.v_scale, jc.v_scale)):
                np.testing.assert_allclose(mine[l].numpy(), np.asarray(theirs[l]), rtol=rtol, atol=0)
    else:
        np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k), **TOL)
        np.testing.assert_allclose(pc.v.numpy(), np.asarray(jc.v), **TOL)
    assert pc.pos == int(jc.pos)


@pytest.mark.parametrize("quant", [True, False], ids=["int8_kv", "f32_kv"])
def test_decoder_prefill_and_ancestry_step_match_jax(weights, audio_kv, quant):
    """Prompt pass over 2 windows x 5 beams sharing int8 audio K/V, then one
    ancestry-indexed decode step with a permuted ancestor table."""
    jp, pp = weights
    xa_j, xa_p = audio_kv
    bw, k, ctx = 2, 5, 64
    bk = bw * k
    jx = jax_decode._quantize_cross_kv(*jax_model.cross_kv(jp, DIMS, xa_j))
    px = pt_decode._quantize_cross_kv(*pt_model.cross_kv(pp, PT, xa_p))
    prompt = np.tile(np.array([[50258, 50259, 50359, 50364]], np.int32), (bk, 1))

    jc = jax_model.KVCache.zeros(DIMS, bk, jnp.float32, ctx=ctx, quant=quant)
    pc = pt_model.KVCache.zeros(PT, bk, torch.float32, ctx=ctx, quant=quant)
    jl, jc = jax_model.decoder_forward(jp, DIMS, jnp.asarray(prompt), *jx, jc)
    pl, pc = pt_model.decoder_forward(pp, PT, torch.from_numpy(prompt).long(), *px, pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _compare_cache(pc, jc, quant)

    rng = np.random.default_rng(2)
    pos = prompt.shape[1]
    anc = rng.integers(0, k, (bw, k, ctx)).astype(np.int32)
    anc[:, :, pos] = np.arange(k)  # each row claims the position it writes
    step = rng.integers(0, 256, (bk, 1)).astype(np.int32)
    jl, jc = jax_model.decoder_forward(jp, DIMS, jnp.asarray(step), *jx, jc,
                                       anc=jnp.asarray(anc))
    pl, pc = pt_model.decoder_forward(pp, PT, torch.from_numpy(step).long(), *px, pc,
                                      anc=torch.from_numpy(anc))
    assert tuple(pl.shape) == (bk, 1, DIMS.n_vocab)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _compare_cache(pc, jc, quant)


def test_quantize_rows_matches_jax():
    # round-half-to-even and the 1e-8 floor, bit for bit on identical input
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((2, 3, 7, 32)).astype(np.float32)
    rows[0, 0, 0] = 0.0  # all-zero row: scale floor
    rows[0, 0, 1, :2] = [127.0, 0.5]  # an exact half-way code
    q, s = pt_model._quantize_rows(torch.from_numpy(rows))
    jq, js = jax_model._quantize_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_cross_probs_teacher_forced_pass_matches_jax(weights, audio_kv):
    """decoder_forward(return_cross_probs=True, skip_logits=True), the
    alignment pass: no logits, float16 probabilities [L, B, H, S, T] that
    sum to one over the audio frames."""
    jp, pp = weights
    xa_j, xa_p = audio_kv
    jk, jv = jax_model.cross_kv(jp, DIMS, xa_j)
    pk, pv = pt_model.cross_kv(pp, PT, xa_p)
    seq = np.random.default_rng(7).integers(0, 50000, (2, 12)).astype(np.int32)
    jc = jax_model.KVCache.zeros(DIMS, 2, jnp.float32, ctx=12)
    pc = pt_model.KVCache.zeros(PT, 2, torch.float32, ctx=12)
    jl, jc, jprobs = jax_model.decoder_forward(
        jp, DIMS, jnp.asarray(seq), jk, jv, jc, return_cross_probs=True, skip_logits=True)
    pl, pc, pprobs = pt_model.decoder_forward(
        pp, PT, torch.from_numpy(seq).long(), pk, pv, pc, return_cross_probs=True,
        skip_logits=True)
    assert jl is None and pl is None
    assert pprobs.dtype == torch.float16
    assert tuple(pprobs.shape) == (DIMS.n_text_layer, 2, DIMS.n_text_head, 12, 1500)
    # probabilities <= 1 that agree to ~1e-6 in f32, then one f16 rounding
    # each (half an ulp is 2^-11 relative)
    np.testing.assert_allclose(pprobs.float().numpy(), np.asarray(jprobs, np.float32),
                               rtol=2.0 ** -10, atol=1e-7)
    np.testing.assert_allclose(pprobs.float().sum(-1).numpy(), 1.0, atol=2e-3)
    _compare_cache(pc, jc, quant=False)
    # with logits, the same pass returns what the plain call returns
    pc2 = pt_model.KVCache.zeros(PT, 2, torch.float32, ctx=12)
    pl2, _, probs2 = pt_model.decoder_forward(
        pp, PT, torch.from_numpy(seq).long(), pk, pv, pc2, return_cross_probs=True)
    pc3 = pt_model.KVCache.zeros(PT, 2, torch.float32, ctx=12)
    pl3, _ = pt_model.decoder_forward(pp, PT, torch.from_numpy(seq).long(), pk, pv, pc3)
    torch.testing.assert_close(pl2, pl3, rtol=0, atol=0)
    assert torch.equal(probs2, pprobs)


def test_cross_probs_refuse_quantised_or_beam_shared_kv(weights, audio_kv):
    _, pp = weights
    _, xa_p = audio_kv
    pk, pv = pt_model.cross_kv(pp, PT, xa_p)
    seq = torch.zeros((4, 2), dtype=torch.int64)  # 4 token rows over 2 windows
    cache = pt_model.KVCache.zeros(PT, 4, torch.float32, ctx=8)
    with pytest.raises(ValueError, match="cross-attention probabilities"):
        pt_model.decoder_forward(pp, PT, seq, pk, pv, cache, return_cross_probs=True)

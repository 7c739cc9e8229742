"""The arithmetic the redesigned CUDA kernels commit to, held against the
JAX package on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py compare them with their plain versions there). What can be
checked here is that the steps they take, written out in plain PyTorch
(``flash_arithmetic_emulation``: key tiles, online max and sum, unnormalised
probabilities rounded before PV; ``ancestor_attention_split_emulation``:
positions in chunks, a global max and sum, weights rounded once after
normalisation, partial PV sums added in chunk order;
``int8_matmul_split_emulation``: one f32 partial sum per K slice of a
cluster rank, added in rank order, then scale, bias and one rounding),
give the JAX functions' results on the same inputs. Inputs are made with numpy from a
seed and handed to both.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from modular_audio_pipeline_tpu.ops import ancestor_attention as jax_anc
from modular_audio_pipeline_tpu.ops import attention as jax_attn
from modular_audio_pipeline_tpu.ops import quant as jax_quant
from modular_audio_pipeline_tpu_torch.ops import ancestor_attention as pt_anc
from modular_audio_pipeline_tpu_torch.ops import attention as pt_attn
from modular_audio_pipeline_tpu_torch.ops import quant as pt_quant
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from test_torch_ops import _anc_case, _jopt, _new_rows, _np, _opt, _t

# bf16: one ulp at |y| in [1, 2) is 7.8e-3, and the emulation rounds the
# unnormalised probabilities where the JAX functions round the normalised
# ones; f32: exp2 against exp and another summation order.
FLASH_TOL = {"bf16": 1e-2, "f32": 1e-4}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape, tile", [
    ((1, 2, 1500, 64), 128), ((2, 3, 129, 64), 128), ((1, 2, 300, 32), 32),
    ((1, 2, 300, 32), 128), ((1, 1, 1, 64), 128),
    ((1, 2, 1001, 32), 64), ((1, 2, 1500, 64), 64), ((2, 1, 65, 32), 64),
], ids=["encoder_length", "one_key_past_a_tile", "hd32_simt_tile", "hd32_wide_tile", "one_key",
        "hd32_key_tile64_one_key_past", "encoder_length_key_tile64", "hd32_key_tile64_65_keys"])
def test_flash_arithmetic_matches_jax(shape, tile, dtype):
    """Both kernel routes take 64-key tiles (``kTileN`` and ``kFmaKeys`` in
    csrc/flash_attention.cu); the other widths hold the arithmetic's claim
    that the tile width moves nothing past the tolerance."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    if dtype == "bf16":
        q, k, v = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v))
    got = _np(pt_attn.flash_arithmetic_emulation(_t(q), _t(k), _t(v), tile=tile))
    assert got.shape == shape and np.isfinite(got).all()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_ref = np.asarray(jax_attn.attention_reference(jq, jk, jv), np.float32)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=FLASH_TOL[dtype])
    want_kernel = np.asarray(jax_attn.flash_attention(jq, jk, jv, interpret=True), np.float32)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=FLASH_TOL[dtype])
    # and the port's own plain version, which the kernel is held to on the card
    plain = _np(pt_attn.attention_reference(_t(q), _t(k), _t(v)))
    np.testing.assert_allclose(got, plain, rtol=0, atol=FLASH_TOL[dtype])


def test_flash_arithmetic_rounds_unnormalised_probabilities():
    """The emulation is not the plain version in disguise: in bf16 its
    rounding of p before normalisation gives other bits somewhere, and in
    f32, where nothing is rounded, tiles of any width agree to 1e-6."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 2, 300, 64)).astype(np.float32) for _ in range(3))
    bf = [_t(x.astype(ml_dtypes.bfloat16)) for x in (q, k, v)]
    assert not torch.equal(pt_attn.flash_arithmetic_emulation(*bf),
                           pt_attn.attention_reference(*bf))
    f32 = [_t(x) for x in (q, k, v)]
    np.testing.assert_allclose(pt_attn.flash_arithmetic_emulation(*f32, tile=128).numpy(),
                               pt_attn.flash_arithmetic_emulation(*f32, tile=32).numpy(),
                               rtol=0, atol=1e-6)


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 bits of precision), floored at the
    spacing of 2^-6: below that the f32 sums' own order dominates."""
    mag = np.maximum(np.abs(x), 2.0 ** -6)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("split", [1, 2, 3, 8])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("has_new", [False, True], ids=["cached", "new_rows"])
def test_ancestry_split_arithmetic_matches_pallas_kernel(quant, has_new, split):
    """bf16 queries. The split changes only the order in which f32 terms
    are added (max is exact; the sum of exp and the PV sums are taken chunk
    by chunk), so a probability or an output may land on the neighbouring
    bf16 value: equal to the Pallas kernel (interpret mode) and to the
    port's plain version within one bf16 ulp of y."""
    q_dtype = ml_dtypes.bfloat16
    q, ck, cv, ks, vs, anc, mask = _anc_case(quant, q_dtype, seed=4)
    pos, layer = 99, 1
    new = (None,) * 4
    if has_new:
        for c in (ck, cv) + ((ks, vs) if quant else ()):
            c[layer, :, :, pos] = 0
        *new, anc = _new_rows(quant, q_dtype, ck, anc, pos, seed=5)
    out = jax_anc._pallas_ancestor_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), _jopt(ks), _jopt(vs),
        layer, jnp.asarray(anc), jnp.asarray(mask), *map(_jopt, new),
        pos if has_new else None, k_beams=anc.shape[1], interpret=True,
    )
    want = np.asarray(out[0] if has_new else out, np.float32)
    mine = [_t(ck), _t(cv), _opt(ks), _opt(vs)]
    got = _np(pt_anc.ancestor_attention_split_emulation(
        _t(q), *mine, layer, _t(anc), _t(mask), *map(_opt, new), pos if has_new else None,
        split=split))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= _bf16_ulp(want)).all(), np.abs(got - want).max()
    plain = [_t(ck), _t(cv), _opt(ks), _opt(vs)]
    ref = _np(pt_anc.ancestor_attention_reference(
        _t(q), *plain, layer, _t(anc), _t(mask), *map(_opt, new), pos if has_new else None))
    assert (np.abs(got - ref) <= _bf16_ulp(ref)).all(), np.abs(got - ref).max()
    if has_new:  # the rows stored at pos, and nothing else, as the Pallas kernel leaves them
        for a, theirs in zip(mine, out[1:]):
            if a is not None:
                np.testing.assert_array_equal(_np(a), np.asarray(theirs, np.float32))


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("has_new", [False, True], ids=["cached", "new_rows"])
def test_ancestry_split_arithmetic_f32_matches_jax_reference(has_new, split):
    """float32 queries over an int8 cache: nothing is rounded to bf16, so
    only the f32 summation order differs; scores reach ~10 here, which
    moves y by a few 1e-6: 1e-5."""
    q, ck, cv, ks, vs, anc, mask = _anc_case(True, np.float32, seed=6)
    pos, layer = 99, 0
    new = (None,) * 4
    if has_new:
        for c in (ck, cv, ks, vs):
            c[layer, :, :, pos] = 0
        *new, anc = _new_rows(True, np.float32, ck, anc, pos, seed=7)
    out = jax_anc.ancestor_attention_reference(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(ks), jnp.asarray(vs),
        layer, jnp.asarray(anc), jnp.asarray(mask), *map(_jopt, new),
        pos if has_new else None,
    )
    want = np.asarray(out[0] if has_new else out)
    got = pt_anc.ancestor_attention_split_emulation(
        _t(q), _t(ck), _t(cv), _t(ks), _t(vs), layer, _t(anc), _t(mask), *map(_opt, new),
        pos if has_new else None, split=split).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _int8_tol(k, terms, mag, bf16_out):
    """The tolerance of chip_smoke.py phase 3b: two f32 summation orders of
    the same exact products, 2 sqrt(K) 2^-24 of the sum of the terms'
    magnitudes times the scale (``terms``), plus one f32 rounding of the
    biased value and, in bf16, one bf16 spacing."""
    tol = 2 * k ** 0.5 * 2.0 ** -24 * terms + 2.0 ** -23 * mag
    return tol + 2.0 ** -7 * mag if bf16_out else tol


def _int8_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32).astype(ml_dtypes.bfloat16)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32).astype(ml_dtypes.bfloat16)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    y = jax_quant.int8_matmul(jnp.asarray(x), jq, js, interpret=True)
    tq, ts = _t(np.asarray(jq)), _t(np.asarray(js))
    terms = (_t(x).float().abs() @ tq.float().abs() * ts).numpy()
    return x, b, y, tq, ts, terms


@pytest.mark.parametrize("epilogue", ["f32", "bf16_bias"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m, k, n", [(80, 1280, 512), (16, 512, 1024), (5, 256, 512)],
                         ids=["decode_step", "language_pass", "few_rows"])
def test_int8_split_emulation_matches_pallas_kernel(m, k, n, splits, epilogue):
    """The int8 product split along K into ``splits`` slices, as the decode
    kernel splits it over a cluster, against the Pallas kernel in interpret
    mode (plus the JAX ``_proj``'s bias and cast for ``bf16_bias``). Only
    the order of f32 sums differs."""
    x, b, y, tq, ts, terms = _int8_case(m, k, n, 40 + splits)
    if epilogue == "f32":
        want = np.asarray(y)
        got = pt_quant.int8_matmul_split_emulation(_t(x), tq, ts, k_slice=k // splits)
        assert got.dtype == torch.float32
    else:
        want = np.asarray((y + jnp.asarray(b).astype(jnp.float32)).astype(jnp.bfloat16),
                          np.float32)
        got = pt_quant.int8_matmul_split_emulation(_t(x), tq, ts, _t(b), torch.bfloat16,
                                                   k_slice=k // splits)
        assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    mag = np.maximum(np.abs(got), np.abs(want))
    tol = _int8_tol(k, terms, mag, epilogue != "f32")
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    # and the plain version the kernel is held to on the card, in f32
    ref = pt_quant.int8_matmul_reference(_t(x), tq, ts).numpy()
    acc32 = pt_quant.int8_matmul_split_emulation(_t(x), tq, ts, k_slice=k // splits).numpy()
    assert (np.abs(acc32 - ref) <= 2 * k ** 0.5 * 2.0 ** -24 * terms).all()


@pytest.mark.parametrize("k, k_slice, slices", [
    (1280, 192, 7), (1280, 640, 2), (640, 128, 5), (384, 64, 6), (5120, 768, 7), (256, 64, 4),
], ids=["proj_7", "proj_2", "k640_5", "k384_6", "fc2_7", "k256_4"])
def test_int8_split_emulation_ragged_last_slice(k, k_slice, slices):
    """Slices of whole 64-row pipeline stages, as the decode kernel's plan
    takes them, with a shorter last slice where K does not divide: as many
    partial sums as slices, their sum within the f32 tolerance of the
    Pallas kernel in interpret mode."""
    assert -(-k // k_slice) == slices and k_slice % 64 == 0
    x, _, y, tq, ts, terms = _int8_case(8, k, 512, k_slice)
    got = pt_quant.int8_matmul_split_emulation(_t(x), tq, ts, k_slice=k_slice).numpy()
    want = np.asarray(y)
    tol = _int8_tol(k, terms, np.maximum(np.abs(got), np.abs(want)), False)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()

"""PyTorch port ops held against the JAX package on the same inputs.

The port's plain versions run here on the CPU (its wrappers take them for
CPU tensors); the JAX side runs its references and its Pallas kernels in
interpret mode, as tests/test_attention.py does. Inputs are made with
numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from modular_audio_pipeline_tpu.ops import ancestor_attention as jax_anc
from modular_audio_pipeline_tpu.ops import attention as jax_attn
from modular_audio_pipeline_tpu.ops.mel import log_mel as jax_log_mel
from modular_audio_pipeline_tpu_torch.ops import ancestor_attention as pt_anc
from modular_audio_pipeline_tpu_torch.ops import attention as pt_attn
from modular_audio_pipeline_tpu_torch.ops.mel import log_mel
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)


def _t(x, dtype=None):
    """numpy -> torch (bf16 numpy arrays go through f32, exactly)."""
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None else t


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    # Tolerance 1e-4: the two FFT implementations sum in different orders;
    # log10 of f32 powers then differs in the last bits.
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((2, 48000))).astype(np.float32)
    want = np.asarray(jax_log_mel(jnp.asarray(audio), n_mels=n_mels))
    got = log_mel(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert got.shape == want.shape == (2, n_mels, 300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_attention_reference_matches_jax_at_encoder_length():
    # S = 1500 is the encoder length: the Pallas kernel pads it to 1536 and
    # masks the tail keys; the port's kernel masks the ragged edge itself.
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 1500, 64)).astype(np.float32) for _ in range(3))
    got = pt_attn.attention_reference(_t(q), _t(k), _t(v)).numpy()
    # f32 against f32: only the summation order differs
    want_ref = np.asarray(jax_attn.attention_reference(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
    # against the Pallas kernel: its online softmax's own tolerance
    # (tests/test_attention.py)
    want_kernel = np.asarray(jax_attn.flash_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True))
    np.testing.assert_allclose(got, want_kernel, rtol=2e-4, atol=2e-4)
    # on CPU tensors the kernel wrapper is the plain version, and no
    # kernel launch is counted
    before = pt_attn.flash_attention.launches
    np.testing.assert_array_equal(pt_attn.flash_attention(_t(q), _t(k), _t(v)).numpy(), got)
    assert pt_attn.flash_attention.launches == before


def _anc_case(quant, q_dtype, seed=0):
    """The shapes of tests/test_attention.py TestAncestorAttention._case."""
    rng = np.random.default_rng(seed)
    BW, K, H, CTX, HD, L = 3, 5, 4, 128, 64, 2
    BK = BW * K
    q = rng.standard_normal((BK, H, 1, HD)).astype(q_dtype)
    if quant:
        ck = rng.integers(-127, 128, (L, BK, H, CTX, HD)).astype(np.int8)
        cv = rng.integers(-127, 128, (L, BK, H, CTX, HD)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (L, BK, H, CTX)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (L, BK, H, CTX)).astype(np.float32)
    else:
        ck = rng.standard_normal((L, BK, H, CTX, HD)).astype(q_dtype)
        cv = rng.standard_normal((L, BK, H, CTX, HD)).astype(q_dtype)
        ks = vs = None
    anc = rng.integers(0, K, (BW, K, CTX)).astype(np.int32)
    mask = np.where(np.arange(CTX) < 100, 0.0, -np.inf).astype(np.float32)
    return q, ck, cv, ks, vs, anc, mask


def _new_rows(quant, q_dtype, ck, anc, pos, seed=1):
    """This step's rows at ``pos``, with the decode loop's invariants: the
    cache is still zero at ``pos`` and every hypothesis claims its own row."""
    rng = np.random.default_rng(seed)
    _, bk, h, _, hd = ck.shape
    if quant:
        nk = rng.integers(-127, 128, (bk, h, 1, hd)).astype(np.int8)
        nv = rng.integers(-127, 128, (bk, h, 1, hd)).astype(np.int8)
        nks = rng.uniform(0.001, 0.02, (bk, h, 1)).astype(np.float32)
        nvs = rng.uniform(0.001, 0.02, (bk, h, 1)).astype(np.float32)
    else:
        nk = rng.standard_normal((bk, h, 1, hd)).astype(q_dtype)
        nv = rng.standard_normal((bk, h, 1, hd)).astype(q_dtype)
        nks = nvs = None
    anc = anc.copy()
    anc[:, :, pos] = np.arange(anc.shape[1])[None, :]
    return nk, nv, nks, nvs, anc


def _opt(x):
    return None if x is None else _t(x)


def _jopt(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("has_new", [False, True], ids=["cached", "new_rows"])
def test_ancestor_reference_matches_pallas_kernel(quant, has_new):
    q_dtype = ml_dtypes.bfloat16
    q, ck, cv, ks, vs, anc, mask = _anc_case(quant, q_dtype)
    pos = 99
    for layer in range(ck.shape[0]):
        ck_l, cv_l = ck.copy(), cv.copy()
        ks_l = None if ks is None else ks.copy()
        vs_l = None if vs is None else vs.copy()
        new = (None,) * 4
        anc_l = anc
        if has_new:
            for c in (ck_l, cv_l) + ((ks_l, vs_l) if quant else ()):
                c[layer, :, :, pos] = 0
            new = _new_rows(quant, q_dtype, ck_l, anc, pos)
            anc_l = new[4]
            new = new[:4]
        out = jax_anc._pallas_ancestor_attention(
            jnp.asarray(q), jnp.asarray(ck_l), jnp.asarray(cv_l), _jopt(ks_l), _jopt(vs_l),
            layer, jnp.asarray(anc_l), jnp.asarray(mask), *map(_jopt, new),
            pos if has_new else None, k_beams=anc.shape[1], interpret=True,
        )
        # JAX dispatches asynchronously and, like torch.from_numpy below, may
        # alias the numpy buffers: its kernel must have read the cache before
        # the port's in-place row store writes into the same memory.
        out = jax.block_until_ready(out)
        pt = [_t(ck_l), _t(cv_l), _opt(ks_l), _opt(vs_l)]
        got = pt_anc.ancestor_attention(
            _t(q), *pt, layer, _t(anc_l), _t(mask), *map(_opt, new),
            pos if has_new else None,
        )
        want_y = out[0] if has_new else out
        assert got.shape == (15, 4, 1, 64) and got.dtype == torch.bfloat16
        # exact: the same bf16 operands, f32 sums and roundings on the CPU
        np.testing.assert_array_equal(_np(got), np.asarray(want_y, np.float32))
        if has_new:
            # the rows written at pos, and nothing else, match exactly
            for mine, theirs in zip(pt, out[1:]):
                if mine is not None:
                    np.testing.assert_array_equal(_np(mine), np.asarray(theirs, np.float32))


@pytest.mark.parametrize("has_new", [False, True], ids=["cached", "new_rows"])
def test_ancestor_reference_f32_matches_jax_reference(has_new):
    # float32 queries over an int8 cache, the CPU tests' decode setting:
    # the JAX reference is exact here (one-hot selection sums one term), so
    # only the f32 summation order differs; scores here reach ~10, so that
    # order moves y by a few 1e-6.
    q, ck, cv, ks, vs, anc, mask = _anc_case(True, np.float32, seed=2)
    pos, layer = 99, 1
    new = (None,) * 4
    if has_new:
        for c in (ck, cv, ks, vs):
            c[layer, :, :, pos] = 0
        *new, anc = _new_rows(True, np.float32, ck, anc, pos, seed=3)
    out = jax_anc.ancestor_attention_reference(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(ks), jnp.asarray(vs),
        layer, jnp.asarray(anc), jnp.asarray(mask), *map(_jopt, new),
        pos if has_new else None,
    )
    out = jax.block_until_ready(out)  # before the port writes into the shared buffers
    pt = [_t(ck), _t(cv), _t(ks), _t(vs)]
    got = pt_anc.ancestor_attention_reference(
        _t(q), *pt, layer, _t(anc), _t(mask), *map(_opt, new), pos if has_new else None)
    want_y = out[0] if has_new else out
    np.testing.assert_allclose(got.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    if has_new:
        for mine, theirs in zip(pt, out[1:]):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_kernel_wrappers_refuse_other_devices():
    # CPU tensors take the plain version; any other non-CUDA device raises
    # rather than computing somewhere else.
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError):
        pt_attn.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        pt_anc.ancestor_attention(
            torch.zeros((5, 1, 1, 64), device="meta"), q, q, None, None, 0,
            torch.zeros((1, 5, 4), dtype=torch.int32, device="meta"),
            torch.zeros((4,), device="meta"),
        )

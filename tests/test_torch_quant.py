"""The port's weight-only int8 ops held against the JAX package's.

Inputs come from numpy with a seed and go through both packages on the
CPU. The JAX ``int8_matmul`` has two branches that do not agree bit for
bit: its Pallas kernel (run here in interpret mode, at shapes its tiling
takes) scales the finished f32 sum, its XLA branch (every other shape,
and the CPU's default) first rounds ``code * bf16(scale)`` to bf16. The
port follows the kernel, so it is held tightly against the kernel and,
within one bf16 rounding per weight, against the XLA branch.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_audio_pipeline_tpu.models.whisper import model as jax_model
from modular_audio_pipeline_tpu.models.whisper.config import WHISPER_DIMS
from modular_audio_pipeline_tpu.ops import quant as jax_quant
from modular_audio_pipeline_tpu_torch.models.whisper import model as pt_model
from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS as PT_DIMS
from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
from modular_audio_pipeline_tpu_torch.ops import quant as pt_quant
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401  (autouse)

DIMS = WHISPER_DIMS["test-tiny"]
PT = PT_DIMS["test-tiny"]


def _case(seed, m, k, n, lead=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((lead or ()) + (m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(128, 256), (3, 64, 48), (1, 5, 7)],
                         ids=["matrix", "stacked", "tiny"])
def test_quantize_weight_equals_jax(shape):
    rng = np.random.default_rng(10)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero column: the 1e-8 scale floor
    quantize = jax_quant.quantize_weight if len(shape) == 2 else jax.vmap(jax_quant.quantize_weight)
    jq, js = quantize(jnp.asarray(w))
    q, s = pt_quant.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == shape[:-2] + shape[-1:]
    # the same f32 division and round-half-to-even on the same input: equal
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("m, k, n", [(8, 256, 512), (8, 256, 1024), (5, 128, 512)])
def test_int8_matmul_matches_jax_kernel_in_interpret_mode(m, k, n):
    """Shapes the Pallas kernel tiles (N % 512 == 0, K % 128 == 0): the
    port computes the kernel's arithmetic, only the order of f32 sums
    differs."""
    x, w = _case(11, m, k, n)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax_quant.int8_matmul(jnp.asarray(x), jq, js, interpret=True))
    got = pt_quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jq)),
                               torch.from_numpy(np.asarray(js)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    # |out| ~ 1; two f32 summation orders over K <= 256 terms
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m, k, n, lead", [
    (8, 256, 512, None), (3, 64, 200, None), (4, 128, 384, (2,)), (1, 96, 40, (2, 3)),
], ids=["tiling", "ragged", "batch_dim", "two_batch_dims"])
def test_int8_matmul_within_one_rounding_of_jax_default_branch(m, k, n, lead):
    """The JAX default (XLA) branch rounds each ``code * bf16(scale)`` to
    bf16 before the product: one rounding of the scale and one of the
    product, each at most 2^-9 relative, so every term is within 2^-8 of
    the port's (rounded up to 2^-7.9 for the second-order term). The sums
    differ by at most that share of the sum of the terms' magnitudes."""
    x, w = _case(12, m, k, n, lead)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax_quant.int8_matmul(jnp.asarray(x), jq, js))
    tq, ts = torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(js))
    got = pt_quant.int8_matmul(torch.from_numpy(x), tq, ts)
    assert tuple(got.shape) == x.shape[:-1] + (n,)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().abs()
    bound = 2.0 ** -7.9 * ((xb @ tq.float().abs()) * ts).numpy() + 1e-6
    assert (np.abs(got.numpy() - want) <= bound).all()
    # and the reference is what the wrapper runs on the CPU
    torch.testing.assert_close(
        got, pt_quant.int8_matmul_reference(torch.from_numpy(x), tq, ts), rtol=0, atol=0)


def test_int8_matmul_rounds_x_to_bf16_also_in_float32():
    x, w = _case(13, 4, 64, 32)
    q, s = pt_quant.quantize_weight(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    torch.testing.assert_close(pt_quant.int8_matmul(xt, q, s),
                               pt_quant.int8_matmul(xt.to(torch.bfloat16), q, s), rtol=0, atol=0)
    exact = (xt @ q.float()) * s
    assert not torch.equal(pt_quant.int8_matmul(xt, q, s), exact)


@pytest.fixture(scope="module")
def trees():
    """Float32 test-tiny weights, the JAX package's quantised tree of them,
    that tree carried across, and the port's own quantised tree."""
    tree = numpy_params(DIMS, seed=14)
    jq = jax_quant.quantize_decoder(jax.tree.map(jnp.asarray, tree))
    carried = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.float32)
    own = pt_quant.quantize_decoder(params_from_numpy(tree, "cpu", torch.float32))
    return jq, carried, own


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_quantize_decoder_equals_jax(trees):
    jq, carried, own = trees
    want, got = _flat(jq), _flat(own)
    assert sorted(got) == sorted(want)
    quantised = [k for k in got if k.endswith("_wq")]
    # every projection of attn, cross and mlp (4 + 4 + 2) and the head
    assert len(quantised) == 11 and "decoder/logits_wq" in quantised
    assert not any(k.endswith("_w") for k in got if "/blocks/attn/" in k or "/mlp/" in k
                   if k.startswith("decoder"))
    assert tuple(got["decoder/logits_wq"].shape) == (
        DIMS.n_text_state, pt_model.padded_vocab(DIMS.n_vocab))
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == _flat(carried)[k].dtype, k
    assert got["decoder/blocks/attn/q_ws"].dtype == torch.float32
    assert got["decoder/logits_wq"].is_contiguous()


def test_params_from_numpy_keeps_scales_f32_in_bf16_mode(trees):
    jq, _, _ = trees
    flat = _flat(params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.bfloat16))
    for k, v in flat.items():
        want = (torch.int8 if k.endswith("_wq") else
                torch.float32 if k.endswith("_ws") else torch.bfloat16)
        assert v.dtype == want, k
    np.testing.assert_array_equal(flat["decoder/logits_ws"].numpy(),
                                  np.asarray(jq["decoder"]["logits_ws"]))


@pytest.fixture(scope="module")
def proxy():
    """The shipped whisper-tiny-synth-proxy bundle in float32: the JAX
    package's quantised tree, that tree carried across, and the log-mel of
    two held-out synthetic sentences."""
    from modular_audio_pipeline_tpu.ops.mel import log_mel
    from modular_audio_pipeline_tpu.training.synth_asr import VOCAB, synth_sentence
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params

    root = Path(__file__).resolve().parents[1]
    tree = load_params(str(root / "modular_audio_pipeline_tpu/weights/whisper-tiny-synth-proxy"))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    jq = jax_quant.quantize_decoder(jax.tree.map(jnp.asarray, tree))
    carried = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.float32)
    rng = np.random.default_rng(500_000)
    audio = np.zeros((2, 480000), np.float32)
    for i in range(2):
        words = rng.integers(0, len(VOCAB), size=int(rng.integers(12, 27)))
        sig = synth_sentence(list(words), rng)
        audio[i, : len(sig)] = sig
    mel = np.asarray(log_mel(jnp.asarray(audio), n_mels=WHISPER_DIMS["tiny"].n_mels))
    return jq, carried, mel


def _kernel_arithmetic(x, wq, ws, interpret=False):
    """The Pallas kernel's arithmetic (quant.py:41-43) at any shape, in jnp:
    what the JAX model computes wherever its kernel's tiling admits the
    projection."""
    y = jnp.dot(x.astype(jnp.bfloat16).astype(jnp.float32), wq.astype(jnp.float32),
                preferred_element_type=jnp.float32)
    return y * ws


def _assert_argmax_equal_outside_near_ties(got, want, tol):
    """Equal argmax wherever the reference's best logit leads its second
    best by more than the two sides can differ (2 * tol)."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    return clear


@pytest.mark.parametrize("branch", ["kernel_arithmetic", "default_branch"])
def test_quantised_decoder_and_cross_kv_match_jax(proxy, branch, monkeypatch):
    """The JAX package's own quantised tree of the trained proxy bundle,
    carried across, through both decoders on two held-out sentences: cross
    K/V, prompt logits and one more position. (Random weights give logits
    so flat that no argmax is clear of the tolerance.)

    ``kernel_arithmetic`` binds the JAX model's product to its kernel's
    arithmetic (the port's). Both round the activations to bf16, and
    activations that differ by 1e-5 (f32 summation order) round to
    neighbouring bf16 values now and then; one such flip moves one term by
    2^-8 of itself. So nearly every K/V value agrees to 1e-3, and the
    logits (of magnitude up to ~20, four layers deep) to 5e-2.
    ``default_branch`` is the JAX
    package as it runs on the CPU: the proxy's widths (384, 1536) always
    take its XLA branch, which rounds code * bf16(scale) to bf16 (2^-8 per weight), so
    through 11 quantised products the logits agree to 1e-1, and the argmax
    is equal wherever the reference's lead exceeds what that can move.
    """
    tol = 5e-2 if branch == "kernel_arithmetic" else 1e-1
    if branch == "kernel_arithmetic":
        monkeypatch.setattr(jax_quant, "int8_matmul", _kernel_arithmetic)
    jq, carried, mel = proxy
    dims_j, dims_p = WHISPER_DIMS["tiny"], PT_DIMS["tiny"]
    xa_j = jax_model.encoder_forward(jq, dims_j, jnp.asarray(mel))
    xa_p = pt_model.encoder_forward(carried, dims_p, torch.from_numpy(mel))
    jk, jv = jax_model.cross_kv(jq, dims_j, xa_j)
    pk, pv = pt_model.cross_kv(carried, dims_p, xa_p)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=0, atol=tol)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    if branch == "kernel_arithmetic":
        assert (np.abs(pk.numpy() - np.asarray(jk)) <= 1e-3).mean() >= 0.98

    prompt = np.tile(np.array([[50258, 50259, 50359, 50364, 11, 250]], np.int32), (2, 1))
    step = np.array([[300], [4000]], np.int32)
    jc = jax_model.KVCache.zeros(dims_j, 2, jnp.float32, ctx=16)
    pc = pt_model.KVCache.zeros(dims_p, 2, torch.float32, ctx=16)
    n_clear = 0
    for toks in (prompt, step):
        jl, jc = jax_model.decoder_forward(jq, dims_j, jnp.asarray(toks), jk, jv, jc)
        pl, pc = pt_model.decoder_forward(carried, dims_p, torch.from_numpy(toks).long(),
                                          pk, pv, pc)
        got, want = pl.numpy(), np.asarray(jl)
        assert got.shape == (2, toks.shape[1], dims_j.n_vocab)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        n_clear += int(_assert_argmax_equal_outside_near_ties(got, want, tol).sum())
    assert n_clear >= 7  # at least half of the 14 positions are clear of near ties


def test_quantised_logits_close_to_unquantised():
    """The JAX package's own acceptance of the int8 decoder (its
    tests/test_quant.py): logits stay close to the unquantised model's and
    pick the same token."""
    tree = numpy_params(DIMS, seed=16)
    params = params_from_numpy(tree, "cpu", torch.float32)
    qparams = pt_quant.quantize_decoder(params)
    mel = np.random.default_rng(17).standard_normal((1, DIMS.n_mels, 3000)).astype(np.float32)
    prompt = torch.tensor([[50258, 50259, 50359, 50364]])
    outs = []
    for p in (params, qparams):
        xa = pt_model.encoder_forward(p, PT, torch.from_numpy(mel))
        k, v = pt_model.cross_kv(p, PT, xa)
        cache = pt_model.KVCache.zeros(PT, 1, torch.float32, ctx=8)
        outs.append(pt_model.decoder_forward(p, PT, prompt, k, v, cache)[0].numpy())
    a, b = outs[0].ravel(), outs[1].ravel()
    assert (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999
    np.testing.assert_array_equal(outs[0][0, -1].argmax(), outs[1][0, -1].argmax())


# -- the fused epilogue: scale, bias in f32, one rounding ---------------------

def _bf16(a):
    import ml_dtypes

    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _proj_tolerance(x, q, s, k, want, got, bf16_out):
    """Two f32 summation orders over K terms: 2 sqrt(K) 2^-24 of the sum of
    the terms' magnitudes, times the scale (the tolerance of the kernel
    check on the card), plus one f32 rounding of the biased value, plus,
    for a bf16 result, one bf16 spacing (at most 2^-7 of the larger of the
    two values): two f32 values that differ by that little may round to
    neighbouring bf16 values."""
    xb = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().abs()
    terms = ((xb @ torch.from_numpy(np.asarray(q)).float().abs()) * torch.from_numpy(
        np.asarray(s))).numpy()
    mag = np.maximum(np.abs(np.asarray(want, np.float32)), np.abs(np.asarray(got, np.float32)))
    tol = 2 * k ** 0.5 * 2.0 ** -24 * terms + 2.0 ** -23 * mag
    if not bf16_out:
        return tol
    return tol + 2.0 ** -7 * mag


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("m, k, n", [(8, 256, 512), (80, 128, 1024), (3, 64, 200), (7, 96, 40)],
                         ids=["kernel_tiling", "decode_rows", "ragged", "ragged_narrow"])
def test_int8_matmul_epilogue_matches_jax_proj(m, k, n, out, with_bias):
    """``int8_matmul_reference(x, wq, ws, bias, out_dtype)`` against the
    JAX ``_proj`` arithmetic on the same inputs: the product (the Pallas
    kernel in interpret mode where its tiling takes the shape, else its
    arithmetic written in jnp), plus ``bias.astype(f32)``, then
    ``astype(y.dtype)``. x and the bias are in the output's type, as in the
    model (the head alone keeps f32 out with bf16 x)."""
    rng = np.random.default_rng(20 + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32)
    if out == "bf16":
        x, b = _bf16(x), _bf16(b)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    jx = jnp.asarray(x)
    tiled = n % 512 == 0 and k % 128 == 0
    y = (jax_quant.int8_matmul(jx, jq, js, interpret=True) if tiled
         else _kernel_arithmetic(jx, jq, js))
    if with_bias:
        y = y + jnp.asarray(b).astype(jnp.float32)
    want = np.asarray(y.astype(jx.dtype))

    tq, ts = torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(js))
    tx = torch.from_numpy(np.asarray(x, np.float32))
    dtype = torch.bfloat16 if out == "bf16" else torch.float32
    tx = tx.to(dtype)
    tb = torch.from_numpy(np.asarray(b, np.float32)).to(dtype) if with_bias else None
    got = pt_quant.int8_matmul_reference(tx, tq, ts, tb, dtype)
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    # the wrapper runs exactly this on a CPU tensor
    assert torch.equal(pt_quant.int8_matmul(tx, tq, ts, tb, dtype), got)
    got32, want32 = got.float().numpy(), np.asarray(want, np.float32)
    tol = _proj_tolerance(x, jq, js, k, want32, got32, out == "bf16")
    assert (np.abs(got32 - want32) <= tol).all(), np.abs(got32 - want32).max()


def _spy(monkeypatch, calls):
    real = pt_model.int8_matmul

    def spy(x, wq, ws, bias=None, out_dtype=torch.float32):
        calls.append({"x_dtype": x.dtype, "wq": wq, "bias": bias, "out_dtype": out_dtype})
        return real(x, wq, ws, bias, out_dtype)

    monkeypatch.setattr(pt_model, "int8_matmul", spy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name, has_bias", [("q", True), ("k", False)])
def test_proj_makes_one_int8_matmul_call(monkeypatch, name, has_bias, dtype):
    """With int8 weights, ``_proj`` is one ``int8_matmul`` call that gets the
    bias and y's type, and returns its result untouched: no separate bias
    add or cast after the kernel."""
    rng = np.random.default_rng(30)
    w = torch.from_numpy((rng.standard_normal((64, 48)) * 0.1).astype(np.float32))
    wq, ws = pt_quant.quantize_weight(w)
    mod = {f"{name}_wq": wq, f"{name}_ws": ws}
    if has_bias:
        mod[f"{name}_b"] = torch.from_numpy(rng.standard_normal(48).astype(np.float32)).to(dtype)
    y = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32)).to(dtype)
    calls = []
    _spy(monkeypatch, calls)
    got = pt_model._proj(y, mod, name)
    assert len(calls) == 1
    assert calls[0]["wq"] is wq and calls[0]["out_dtype"] == dtype
    assert calls[0]["bias"] is mod.get(f"{name}_b")
    assert got.dtype == dtype and tuple(got.shape) == (2, 3, 48)
    want = pt_quant.int8_matmul_reference(y, wq, ws, mod.get(f"{name}_b"), dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_decoder_pass_calls_the_kernel_once_per_product(monkeypatch, dtype):
    """One quantised decoder pass: 8 products per layer (self q, k, v, o,
    cross q, o, fc1, fc2), each with its bias (self-attention k has none)
    and the activations' type, and the head with neither, in f32."""
    params = pt_quant.quantize_decoder(
        pt_model.init_params(PT, torch.Generator().manual_seed(31), dtype))
    mel = torch.from_numpy(
        np.random.default_rng(32).standard_normal((1, PT.n_mels, 3000)).astype(np.float32))
    xa = pt_model.encoder_forward(params, PT, mel.to(dtype))
    xk, xv = pt_model.cross_kv(params, PT, xa)
    cache = pt_model.KVCache.zeros(PT, 1, dtype, ctx=8)
    calls = []
    _spy(monkeypatch, calls)
    logits, _ = pt_model.decoder_forward(params, PT, torch.tensor([[50258, 50259, 50359]]),
                                         xk, xv, cache)
    assert len(calls) == 8 * PT.n_text_layer + 1
    *proj, head = calls
    assert head["bias"] is None and head["out_dtype"] == torch.float32
    assert head["wq"] is params["decoder"]["logits_wq"] and logits.dtype == torch.float32
    assert all(c["out_dtype"] == dtype and c["x_dtype"] == dtype for c in proj)
    assert sum(c["bias"] is None for c in proj) == PT.n_text_layer  # self-attention k
    assert all(c["bias"] is None or c["bias"].dtype == dtype for c in proj)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the decision is
taken inside the ``cuda`` fixture, at run time). On a machine with the card
run them without the repository's JAX test configuration::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes cover the ragged edges the main path never shows: sequence lengths
that are not a tile multiple, one beam, head dim 32, partly masked context.
"""

import numpy as np
import pytest
import torch

from modular_audio_pipeline_tpu_torch.ops import ancestor_attention as anc_ops
from modular_audio_pipeline_tpu_torch.ops import attention as attn_ops
from modular_audio_pipeline_tpu_torch.ops import quant as quant_ops

# bf16: one ulp at |y| in [1, 2) is 7.8e-3; the kernels sum in f32 in another
# order than the plain versions (and the flash kernel rounds the unnormalised
# probabilities to bf16 where the plain version rounds the normalised ones),
# so a rounded value may land on the neighbouring bf16 value. f32: fast exp
# and summation order.
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 64), (2, 3, 129, 64), (1, 2, 1500, 32),
                                   (1, 1, 300, 64), (2, 2, 1501, 64), (16, 20, 1500, 64)])
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    """Ragged query and key tiles (1, 129, 300, 1500, 1501 are no multiples
    of 128), several heads (a tail tile must not reach the next head: the
    whole tensor is compared) and the encoder's own shape; bf16 at head dim
    64 runs on the tensor cores, the rest on the CUDA-core route."""
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(dtype) for _ in range(3))
    before = attn_ops.flash_attention.launches
    out = attn_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    err = (out.float() - attn_ops.attention_reference(q, k, v).float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("shape", [(2, 3, 300, 64), (4, 20, 1500, 64), (1, 2, 300, 32)])
def test_flash_kernel_gives_equal_bits_twice(cuda, shape):
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    first = attn_ops.flash_attention(q, k, v)
    second = attn_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn((1, 2, 64, 64), generator=cuda, device="cuda")
    with pytest.raises(ValueError):
        attn_ops.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError):
        attn_ops.flash_attention(q.half(), q.half(), q.half())
    w = torch.randn((1, 2, 64, 48), generator=cuda, device="cuda")
    with pytest.raises(ValueError):
        attn_ops.flash_attention(w, w, w)
    # the tensor-core path loads 16-byte vectors: a view that starts off them is refused
    buf = torch.zeros(3 * 2 * 64 * 64 + 8, device="cuda", dtype=torch.bfloat16)
    odd = buf[1:1 + 2 * 64 * 64].view(1, 2, 64, 64)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(odd, odd, odd)


def _anc_case(g, q_dtype, cache_dtype, bw, kq, h, ctx, hd, n_valid, shared=False):
    dev = "cuda"
    n_layers, layer, pos = 2, 1, n_valid - 1
    bk = bw * kq
    q = (torch.randn((bk, h, 1, hd), generator=g, device=dev) * hd ** -0.5).to(q_dtype)
    if cache_dtype == torch.int8:
        def codes(*s):
            return torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)

        def scales(*s):
            return torch.rand(s, generator=g, device=dev) * 0.02 + 0.001

        cache = [codes(n_layers, bk, h, ctx, hd), codes(n_layers, bk, h, ctx, hd),
                 scales(n_layers, bk, h, ctx), scales(n_layers, bk, h, ctx)]
        new = [codes(bk, h, 1, hd), codes(bk, h, 1, hd), scales(bk, h, 1), scales(bk, h, 1)]
    else:
        cache = [torch.randn((n_layers, bk, h, ctx, hd), generator=g, device=dev)
                 .to(cache_dtype) for _ in range(2)] + [None, None]
        new = [torch.randn((bk, h, 1, hd), generator=g, device=dev).to(cache_dtype)
               for _ in range(2)] + [None, None]
    anc = torch.randint(0, kq, (bw, kq, ctx), generator=g, device=dev, dtype=torch.int32)
    if shared:  # as in real decoding: the beams differ in their last few tokens only
        anc[:, :, :max(pos - 2, 0)] = anc[:, :1, :max(pos - 2, 0)]
    anc[:, :, pos] = torch.arange(kq, device=dev, dtype=torch.int32)
    mask = torch.where(torch.arange(ctx, device=dev) < n_valid, 0.0, float("-inf"))
    return q, cache, new, anc, mask, layer, pos


@pytest.mark.parametrize("has_new", [False, True], ids=["cached", "new_rows"])
@pytest.mark.parametrize("q_dtype, cache_dtype", [
    (torch.bfloat16, torch.int8), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.int8), (torch.float32, torch.float32),
], ids=["bf16_int8", "bf16_bf16", "f32_int8", "f32_f32"])
@pytest.mark.parametrize("bw, kq, h, ctx, hd, n_valid", [
    (2, 5, 3, 64, 64, 37), (3, 1, 2, 128, 32, 128), (1, 8, 4, 448, 64, 300),
])
def test_ancestry_kernel_matches_plain(cuda, q_dtype, cache_dtype, has_new,
                                       bw, kq, h, ctx, hd, n_valid):
    q, cache, new, anc, mask, layer, pos = _anc_case(
        cuda, q_dtype, cache_dtype, bw, kq, h, ctx, hd, n_valid)
    if not has_new:
        new = [None] * 4
    mine = [None if c is None else c.clone() for c in cache]
    plain = [None if c is None else c.clone() for c in cache]
    before = anc_ops.ancestor_attention.launches
    y = anc_ops.ancestor_attention(q, *mine, layer, anc, mask, *new, pos if has_new else None)
    y_ref = anc_ops.ancestor_attention_reference(
        q, *plain, layer, anc, mask, *new, pos if has_new else None)
    torch.cuda.synchronize()
    assert anc_ops.ancestor_attention.launches == before + 1
    assert y.shape == q.shape and y.dtype == q_dtype
    err = (y.float() - y_ref.float()).abs().max().item()
    assert err <= TOL[q_dtype], err
    for a, b in zip(mine, plain):
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("split", [0, 1, 2, 4], ids=["auto", "one_block", "split2", "split4"])
@pytest.mark.parametrize("q_dtype, cache_dtype", [
    (torch.bfloat16, torch.int8), (torch.float32, torch.float32),
], ids=["bf16_int8", "f32_f32"])
@pytest.mark.parametrize("bw, kq, h, ctx, hd, n_valid", [
    (16, 5, 20, 448, 64, 448), (2, 5, 3, 64, 64, 37), (1, 12, 2, 130, 32, 101),
])
def test_ancestry_kernel_shared_ancestry_and_splits(cuda, q_dtype, cache_dtype, split,
                                                    bw, kq, h, ctx, hd, n_valid):
    """Beams that share their ancestry up to the last positions (every
    hypothesis reads the same rows), with the positions of a (window, head)
    in one block or split over a cluster of 2 or 4, and more beams than one
    pass of the PV sums holds: the plain version's values, the new rows
    stored, and the same bits on a second run."""
    q, cache, new, anc, mask, layer, pos = _anc_case(
        cuda, q_dtype, cache_dtype, bw, kq, h, ctx, hd, n_valid, shared=True)
    mine = [None if c is None else c.clone() for c in cache]
    plain = [None if c is None else c.clone() for c in cache]
    y = anc_ops.ancestor_attention(q, *mine, layer, anc, mask, *new, pos, split=split)
    y_ref = anc_ops.ancestor_attention_reference(q, *plain, layer, anc, mask, *new, pos)
    again = anc_ops.ancestor_attention(q, *mine, layer, anc, mask, split=split)
    torch.cuda.synchronize()
    err = (y.float() - y_ref.float()).abs().max().item()
    assert err <= TOL[q_dtype], err
    assert torch.equal(y, again)
    for a, b in zip(mine, plain):
        if a is not None:
            assert torch.equal(a, b)


def test_ancestry_kernel_takes_rows_it_cannot_read_in_place(cuda):
    """New rows that are views (not contiguous) are stored by copies before
    the launch instead of by the kernel: same output, same cache."""
    q, cache, new, anc, mask, layer, pos = _anc_case(
        cuda, torch.bfloat16, torch.int8, 2, 5, 3, 64, 64, 37)
    wide = [torch.cat([t, t], dim=-1) for t in new]  # rows as the left halves of wider tensors
    views = [w[..., :t.shape[-1]] for w, t in zip(wide, new)]
    assert not views[0].is_contiguous()
    mine = [c.clone() for c in cache]
    plain = [c.clone() for c in cache]
    y = anc_ops.ancestor_attention(q, *mine, layer, anc, mask, *views, pos)
    y_ref = anc_ops.ancestor_attention_reference(q, *plain, layer, anc, mask, *new, pos)
    torch.cuda.synchronize()
    assert (y.float() - y_ref.float()).abs().max().item() <= TOL[torch.bfloat16]
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)
    # a position past the context writes the last row, as the plain version
    # (and the JAX package's clamped dynamic_update_slice) does
    y = anc_ops.ancestor_attention(q, *mine, layer, anc, mask, *new, 64)
    y_ref = anc_ops.ancestor_attention_reference(q, *plain, layer, anc, mask, *new, 64)
    torch.cuda.synchronize()
    assert (y.float() - y_ref.float()).abs().max().item() <= TOL[torch.bfloat16]
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)
    assert torch.equal(mine[0][layer, :, :, 63], new[0][:, :, 0])
    with pytest.raises(ValueError):
        anc_ops.ancestor_attention(q, *mine, layer, anc, mask, *new, -1)


def test_ancestry_kernel_refuses_what_it_does_not_take(cuda):
    q, cache, new, anc, mask, layer, pos = _anc_case(
        cuda, torch.bfloat16, torch.int8, 2, 5, 3, 64, 64, 37)
    with pytest.raises(RuntimeError):  # more blocks than a portable cluster holds
        anc_ops.ancestor_attention(q, *cache, layer, anc, mask, split=16)
    with pytest.raises(ValueError):
        anc_ops.ancestor_attention(q.half(), *cache, layer, anc, mask)
    with pytest.raises(ValueError):
        anc_ops.ancestor_attention(q, *cache, layer, anc.long(), mask)
    with pytest.raises(ValueError):
        anc_ops.ancestor_attention(q, cache[0], cache[1], None, None, layer, anc, mask)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m, k, n", [
    (1, 1, 1), (3, 64, 200), (80, 384, 384), (33, 100, 48), (7, 31, 17), (300, 257, 130),
    (129, 64, 1040), (2, 1280, 5120), (80, 1280, 1280), (16, 640, 96), (17, 130, 72),
    (400, 1280, 1280),
])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, dtype):
    """Aligned and ragged M, K, N (vector and scalar code loads, one and
    five row tiles, narrow and wide column tiles, with and without the
    split along K) against the plain version on the same inputs."""
    x = torch.randn((m, k), generator=cuda, device="cuda").to(dtype)
    wq = torch.randint(-127, 128, (k, n), generator=cuda, device="cuda", dtype=torch.int8)
    ws = torch.rand((n,), generator=cuda, device="cuda") * 0.01 + 1e-4
    before = quant_ops.int8_matmul.launches
    out = quant_ops.int8_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert quant_ops.int8_matmul.launches == before + 1
    assert out.shape == (m, n) and out.dtype == torch.float32
    ref = quant_ops.int8_matmul_reference(x, wq, ws)
    tol = _int8_tol(x, wq, ws, ref, torch.float32)
    assert bool(((out - ref).abs() <= tol + 1e-30).all()), (out - ref).abs().max().item()


def test_int8_matmul_kernel_takes_batch_dims_and_views(cuda):
    """Leading batch dims, a layer slice of stacked codes (the decoder's
    layout) and a non-contiguous x."""
    x = torch.randn((2, 5, 96), generator=cuda, device="cuda").to(torch.bfloat16)
    wq = torch.randint(-127, 128, (3, 96, 80), generator=cuda, device="cuda", dtype=torch.int8)
    ws = torch.rand((3, 80), generator=cuda, device="cuda") * 0.01
    out = quant_ops.int8_matmul(x, wq[1], ws[1])
    assert out.shape == (2, 5, 80)
    torch.testing.assert_close(out, quant_ops.int8_matmul_reference(x, wq[1], ws[1]),
                               rtol=1e-4, atol=1e-4)  # f32 summation order
    xt = x.transpose(0, 1)
    torch.testing.assert_close(quant_ops.int8_matmul(xt, wq[2], ws[2]),
                               quant_ops.int8_matmul_reference(xt, wq[2], ws[2]),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        quant_ops.int8_matmul(x.half(), wq[0], ws[0])
    with pytest.raises(ValueError):
        quant_ops.int8_matmul(x, wq[0].float(), ws[0])
    with pytest.raises(ValueError):
        quant_ops.int8_matmul(x[..., :64], wq[0], ws[0])


# (M, K, N): the decode step's projections and head, the cross K/V, the
# alignment pass, the prompt pass, and ragged shapes for the other kernels
INT8_SHAPES = [(80, 1280, 1280), (80, 1280, 5120), (80, 5120, 1280), (80, 1280, 51968),
               (24000, 1280, 1280), (3000, 1280, 5120), (320, 1280, 1280), (16, 1280, 51968),
               (100, 640, 384), (3, 64, 200), (33, 100, 48), (129, 64, 1040)]


def _int8_case(g, m, k, n, bias_dtype):
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device="cuda") * 0.002 + 1e-4
    b = None if bias_dtype is None else (
        torch.randn((n,), generator=g, device="cuda") * 0.1).to(bias_dtype)
    return x, wq, ws, b


def _int8_tol(x, wq, ws, ref, out_dtype):
    """Two f32 summation orders of the same exact products (bf16 x int8):
    rounding errors that add like a random walk, 2 sqrt(K) 2^-24 of the sum
    of the terms' magnitudes, times the scale (sound runs stay below a
    tenth of it; an output or accumulator rounded to bf16 is far outside);
    plus one f32 rounding of the biased value and, in bf16, one bf16
    spacing (2^-7 of the value at most)."""
    k = wq.shape[0]
    terms = x.to(torch.bfloat16).float().abs() @ wq.float().abs()
    tol = 2 * k ** 0.5 * 2.0 ** -24 * terms * ws + 2.0 ** -23 * ref.abs()
    return tol + 2.0 ** -7 * ref.abs() if out_dtype == torch.bfloat16 else tol


@pytest.mark.parametrize("out_dtype, bias_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, None), (torch.float32, torch.float32),
], ids=["proj_bf16", "head_f32", "f32_bias"])
@pytest.mark.parametrize("m, k, n", INT8_SHAPES)
def test_int8_matmul_kernel_epilogue_matches_plain(cuda, m, k, n, out_dtype, bias_dtype):
    """The fused epilogue (scale, bias in f32, one rounding) at the main
    path's shapes and ragged ones: within tolerance of the plain version,
    the same bits on a second run, one launch per product."""
    x, wq, ws, b = _int8_case(cuda, m, k, n, bias_dtype)
    before = quant_ops.int8_matmul.launches
    out = quant_ops.int8_matmul(x, wq, ws, b, out_dtype)
    again = quant_ops.int8_matmul(x, wq, ws, b, out_dtype)
    torch.cuda.synchronize()
    assert quant_ops.int8_matmul.launches == before + 2
    assert out.dtype == out_dtype and out.shape == (m, n)
    assert torch.equal(out, again)
    ref = quant_ops.int8_matmul_reference(x, wq, ws, b, torch.float32)
    diff = (out.float() - ref).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((diff <= _int8_tol(x, wq, ws, ref, out_dtype) + 1e-30).all()), diff.max().item()


# (K, N) at which the decode kernel's plan takes each cluster size on 132 SMs
INT8_CLUSTER_SHAPES = {1: (1280, 8448), 2: (1280, 5120), 3: (192, 1280), 4: (1280, 2560),
                       5: (640, 1280), 6: (384, 1280), 7: (1280, 1280), 8: (5120, 1280)}


@pytest.mark.parametrize("cluster", sorted(INT8_CLUSTER_SHAPES))
@pytest.mark.parametrize("m", [16, 80, 128])
def test_int8_matmul_kernel_every_cluster_size(cuda, m, cluster):
    """The decode kernel at each cluster size its plan can take, reached
    through the shape: against the plain version and against the emulation
    of its split (partial sums of the ranks' K slices added in rank order),
    equal bits twice."""
    k, n = INT8_CLUSTER_SHAPES[cluster]
    x, wq, ws, b = _int8_case(cuda, m, k, n, torch.bfloat16)
    plan = quant_ops.plan(m, k, n)
    assert plan["route"] == 1 and plan["cols"] == 64 and plan["cluster"] == cluster, plan
    assert (cluster - 1) * plan["k_slice"] < k <= cluster * plan["k_slice"], plan
    out = quant_ops.int8_matmul(x, wq, ws, b, torch.float32)
    again = quant_ops.int8_matmul(x, wq, ws, b, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = quant_ops.int8_matmul_reference(x, wq, ws, b, torch.float32)
    tol = _int8_tol(x, wq, ws, ref, torch.float32)
    assert bool(((out - ref).abs() <= tol + 1e-30).all())
    emu = quant_ops.int8_matmul_split_emulation(x, wq, ws, b, torch.float32,
                                                k_slice=plan["k_slice"])
    assert bool(((out - emu).abs() <= tol + 1e-30).all())


@pytest.mark.parametrize("m, k, n", [(80, 1280, 1280), (80, 5120, 1280), (80, 1280, 51968)])
def test_int8_tolerance_rejects_lower_precision(cuda, m, k, n):
    """The tolerance the kernel is held to fails a product that keeps less
    than f32: the plain version's output rounded to bf16, and the JAX
    package's other branch (code x scale rounded to bf16 before the sum)."""
    x, wq, ws, _ = _int8_case(cuda, m, k, n, None)
    ref = quant_ops.int8_matmul_reference(x, wq, ws)
    tol = _int8_tol(x, wq, ws, ref, torch.float32)
    rounded = ref.to(torch.bfloat16).float()
    other = x.float() @ (wq.float() * ws).to(torch.bfloat16).float()
    for control in (rounded, other):
        assert not bool(((control - ref).abs() <= tol).all())


def test_int8_decoder_pass_makes_one_launch_per_product(cuda):
    """One int8 decoder pass of large-v3-turbo (4 layers, 80 rows: 16
    windows x 5 beams) launches the kernel 33 times (8 projections per
    layer and the head) and nothing else of it: no reduction kernel."""
    from torch.profiler import ProfilerActivity, profile

    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.models.whisper.model import (
        KVCache, cross_kv, decoder_forward, init_params,
    )

    dims = WHISPER_DIMS["large-v3-turbo"]
    params = quant_ops.quantize_decoder(init_params(dims, cuda, torch.bfloat16, device="cuda"))
    del params["encoder"]
    xa = torch.randn((80, dims.n_audio_ctx, dims.n_audio_state), generator=cuda,
                     device="cuda").to(torch.bfloat16)
    xk, xv = cross_kv(params, dims, xa)
    del xa
    cache = KVCache.zeros(dims, 80, torch.bfloat16, ctx=8, quant=True, device="cuda")
    tokens = torch.full((80, 1), 50258, device="cuda")
    decoder_forward(params, dims, tokens, xk, xv, cache)  # warm-up
    cache.pos = 0
    torch.cuda.synchronize()
    before = quant_ops.int8_matmul.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits, _ = decoder_forward(params, dims, tokens, xk, xv, cache)
        torch.cuda.synchronize()
    assert quant_ops.int8_matmul.launches - before == 8 * dims.n_text_layer + 1 == 33
    names = [(e.key, e.count) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and "int8_matmul" in e.key]
    assert sum(n for _, n in names) == 33, names
    assert not any("reduce" in k for k, _ in names), names
    assert logits.shape[0] == 80 and bool(torch.isfinite(logits).all())


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}


def test_decode_on_card_matches_cpu(cuda):
    """test-tiny beam decode through both kernels gives the CPU port's
    tokens (float32 weights, int8 KV cache)."""
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.models.whisper.decode import (
        DecodeOptions, decode_windows,
    )
    from modular_audio_pipeline_tpu_torch.models.whisper.model import init_params
    from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer

    dims = WHISPER_DIMS["test-tiny"]
    params = init_params(dims, torch.Generator().manual_seed(0), torch.float32)
    mel = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, dims.n_mels, 3000)).astype(np.float32))
    tok = load_tokenizer(None, dims.n_vocab)
    opts = DecodeOptions(language="en", beam_size=5, max_tokens=32)
    want = decode_windows(params, dims, tok, mel, opts)
    gpu = _to_cuda(params)
    launches = (attn_ops.flash_attention.launches, anc_ops.ancestor_attention.launches)
    got = decode_windows(gpu, dims, tok, mel.cuda(), opts)
    assert attn_ops.flash_attention.launches == launches[0] + dims.n_audio_layer
    assert anc_ops.ancestor_attention.launches > launches[1]
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.sum_logprobs, want.sum_logprobs, rtol=0, atol=1e-3)


def test_int8_decode_on_card_matches_cpu(cuda):
    """test-tiny decodes with the quantised decoder: all three kernels on
    the card against the CPU port's plain versions (float32 activations,
    int8 KV cache). Both round the activations to bf16 before each
    quantised product, and activations that differ by 1e-6 (f32 sums in
    another order) now and then round to neighbouring bf16 values, which
    moves one term by 2^-8 of itself: the prompt's logits agree to 2e-2.
    Random weights give nearly flat distributions, so that noise can flip
    a near-tie late in a decode and the rest of that window then differs: the first 8 tokens of every window must be equal and 3 of 4
    positions overall, and the summed log-probabilities agree to 0.5."""
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.models.whisper.decode import (
        DecodeOptions, decode_windows, encode_audio_kv,
    )
    from modular_audio_pipeline_tpu_torch.models.whisper.model import (
        KVCache, decoder_forward, init_params,
    )
    from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer

    dims = WHISPER_DIMS["test-tiny"]
    params = quant_ops.quantize_decoder(
        init_params(dims, torch.Generator().manual_seed(0), torch.float32))
    gpu = _to_cuda(params)
    mel = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, dims.n_mels, 3000)).astype(np.float32))
    tok = load_tokenizer(None, dims.n_vocab)

    prompt = torch.tensor([[50258, 50259, 50359, 50364]] * 2)
    logits = []
    for p, dev in ((params, "cpu"), (gpu, "cuda")):
        xa_k, xa_v = encode_audio_kv(p, dims, mel.to(dev))
        cache = KVCache.zeros(dims, 2, torch.float32, ctx=8, device=dev)
        logits.append(decoder_forward(p, dims, prompt.to(dev), xa_k, xa_v, cache)[0].cpu())
    torch.testing.assert_close(logits[1], logits[0], rtol=0, atol=2e-2)

    for beam_size in (1, 5):
        opts = DecodeOptions(language="en", beam_size=beam_size, max_tokens=32)
        want = decode_windows(params, dims, tok, mel, opts)
        before = quant_ops.int8_matmul.launches
        got = decode_windows(gpu, dims, tok, mel.cuda(), opts)
        # cross K/V (2 per layer), then the prompt pass and every step:
        # 8 projections per layer + the head
        per_pass = 8 * dims.n_text_layer + 1
        passes, rest = divmod(
            quant_ops.int8_matmul.launches - before - 2 * dims.n_text_layer, per_pass)
        assert rest == 0 and passes >= 2
        np.testing.assert_array_equal(got.tokens[:, :8], want.tokens[:, :8])
        assert (got.tokens == want.tokens).mean() >= 0.75
        same = (got.tokens == want.tokens).all(axis=1)
        # equal tokens: sums of <= 33 log-probabilities that agree to 2e-2
        # each at worst; a window that took another path: within 5%
        np.testing.assert_allclose(got.sum_logprobs[same], want.sum_logprobs[same],
                                   rtol=0, atol=0.1)
        np.testing.assert_allclose(got.sum_logprobs, want.sum_logprobs, rtol=0.05, atol=0)


@pytest.mark.parametrize("shape", [(32, 4, 1000, 32), (2, 4, 1001, 32)])
def test_flash_kernel_at_the_segmentation_shape(cuda, shape):
    """SegmentationNet's call: f32 at head dim 32 (the CUDA-core route), S 1000
    and a ragged 1001, within the f32 tolerance and equal bits twice."""
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda") for _ in range(3))
    out, again = attn_ops.flash_attention(q, k, v), attn_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = (out - attn_ops.attention_reference(q, k, v)).abs().max().item()
    assert err <= TOL[torch.float32], err
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype, hd", [(torch.float32, 32), (torch.float32, 64),
                                       (torch.bfloat16, 32)], ids=["f32_hd32", "f32_hd64", "bf16_hd32"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 1000, 1001])
def test_flash_cuda_core_route_at_tile_edges(cuda, s, dtype, hd):
    """The CUDA-core route's three instantiations at the edges of its 64-key
    and 128-query tiles, over three heads (the whole tensor is compared, so
    a tail tile that reached the next head would show): within the
    tolerance of the plain version, equal bits in two runs, one launch a call."""
    q, k, v = (torch.randn((1, 3, s, hd), generator=cuda, device="cuda").to(dtype)
               for _ in range(3))
    before = attn_ops.flash_attention.launches
    out, again = attn_ops.flash_attention(q, k, v), attn_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention.launches == before + 2
    err = (out.float() - attn_ops.attention_reference(q, k, v).float()).abs().max().item()
    assert err <= TOL[dtype], err
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype, hd", [(torch.float32, 32), (torch.float32, 64),
                                       (torch.bfloat16, 32)], ids=["f32_hd32", "f32_hd64", "bf16_hd32"])
def test_flash_cuda_core_route_refuses_unaligned_views(cuda, dtype, hd):
    """The route copies 16 bytes at a time, so a view that starts off a
    16-byte boundary is refused, not read misaligned."""
    buf = torch.zeros(2 * 64 * hd + 8, device="cuda", dtype=dtype)
    odd = buf[1:1 + 2 * 64 * hd].view(1, 2, 64, hd)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(odd, odd, odd)


def test_serving_networks_on_card_match_cpu(cuda):
    """The ConvVAD, SegmentationNet (through the flash kernel) and
    ConvEmbedder of the shipped bundles on the card against the same
    modules on the CPU: the f32 convolutions run with TF32 off, so the CPU
    tests' tolerances hold (probabilities and embeddings 1e-5; the f16
    marginals one ulp)."""
    from modular_audio_pipeline_tpu_torch.models.diarization.embedding import ConvEmbedder
    from modular_audio_pipeline_tpu_torch.models.diarization.features import mfcc_batch
    from modular_audio_pipeline_tpu_torch.models.diarization.segmentation import SegmentationNet
    from modular_audio_pipeline_tpu_torch.models.vad_net import ConvVAD
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params
    from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

    rng = np.random.default_rng(8)
    t = np.arange(20 * 16000) / 16000
    x = (0.3 * np.sin(2 * np.pi * 150 * t) * (np.sin(2 * np.pi * 0.7 * t) > 0)
         + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    x = torch.from_numpy(x)

    def both(cls, bundle):
        params = load_params(str(SHIPPED_WEIGHTS / bundle))
        return cls(params, device="cuda"), cls(params, device="cpu")

    gpu, cpu = both(ConvVAD, "vad-silero")
    feats = ConvVAD.features(x)
    assert (gpu(feats.cuda()).cpu() - cpu(feats)).abs().max().item() <= 1e-5
    gpu, cpu = both(ConvEmbedder, "diarization-embedding")
    spans = x[: 8 * 24000].reshape(8, 24000)
    assert np.abs(gpu.embed(spans.cuda()) - cpu.embed(spans)).max() <= 1e-5
    gpu, cpu = both(SegmentationNet, "diarization-segmentation")
    mel = mfcc_batch(x.reshape(2, -1), n_mfcc=40, n_mels=40)
    before = attn_ops.flash_attention.launches
    mg = gpu.marginals(mel.cuda()).cpu()
    assert attn_ops.flash_attention.launches == before + SegmentationNet.LAYERS
    ulps = (mg.view(torch.int16).int() - cpu.marginals(mel).view(torch.int16).int()).abs()
    assert ulps.max().item() <= 1


# -- training: the flash kernel's gradient and a train step --------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 129, 64), (1, 2, 1500, 32), (2, 4, 1001, 32),
                                   (2, 20, 1500, 64)])
def test_flash_gradient_matches_plain(cuda, shape):
    """On a CUDA tensor that needs a gradient, flash_attention goes through
    its autograd.Function: one kernel launch forward, and q/k/v gradients
    from the plain version's recompute, held to the f32 tolerance over the
    largest gradient."""
    q, k, v, g = (torch.randn(shape, generator=cuda, device="cuda") for _ in range(4))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = attn_ops.flash_attention.launches
    out = attn_ops.flash_attention(qa, ka, va)
    assert out.grad_fn is not None and attn_ops.flash_attention.launches == before + 1
    out.backward(g)
    assert attn_ops.flash_attention.launches == before + 1  # the backward launches nothing
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    attn_ops.attention_reference(qr, kr, vr).backward(g)
    for got, want in ((qa.grad, qr.grad), (ka.grad, kr.grad), (va.grad, vr.grad)):
        assert ((got - want).abs().max() / want.abs().max()).item() <= TOL[torch.float32]


def test_flash_saves_nothing_without_autograd(cuda):
    """Under no_grad, or when no input needs a gradient, the kernel is
    launched directly: no graph, nothing saved."""
    q, k, v = (torch.randn((1, 2, 300, 64), generator=cuda, device="cuda", requires_grad=True)
               for _ in range(3))
    with torch.no_grad():
        out = attn_ops.flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    out = attn_ops.flash_attention(q.detach(), k.detach(), v.detach())
    assert out.grad_fn is None
    only_q = attn_ops.flash_attention(q, k.detach(), v.detach())
    only_q.sum().backward()
    assert q.grad is not None and k.grad is None and v.grad is None


def test_train_step_on_card_matches_cpu(cuda):
    """Two AdamW steps at test-tiny from the shipped bundle, the encoder's
    attention through the kernel and its recompute backward on the card:
    losses within 1e-5 relative of the CPU's, every leaf's gradient at step
    0 within 1e-4 of its norm, parameters after two steps under the Adam
    sign-flip tolerance (tests/test_torch_training.py)."""
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import (
        load_params, params_from_numpy)
    from modular_audio_pipeline_tpu_torch.training import optim
    from modular_audio_pipeline_tpu_torch.training import whisper_train as wt
    from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

    dims = WHISPER_DIMS["test-tiny"]
    tree = load_params(str(SHIPPED_WEIGHTS / "whisper-test-tiny"))
    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.standard_normal((2, dims.n_mels, 3000)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 300, (2, 24))).long()
    targets = torch.roll(tokens, -1, 1)
    targets[:, :3] = wt.IGNORE_INDEX
    runs = {}
    for dev in ("cuda", "cpu"):
        params = params_from_numpy(tree, dev, torch.float32)
        init_state, step = wt.make_train_step(dims, optim.adamw(1e-3, weight_decay=0.01))
        state = init_state(params)
        batch = [t.to(dev) for t in (mel, tokens, targets)]
        before = attn_ops.flash_attention.launches
        state, loss0 = step(state, *batch)
        grads = [p.grad.cpu() for p in wt.tree_leaves(state.params)]
        state, loss1 = step(state, *batch)
        launched = attn_ops.flash_attention.launches - before
        runs[dev] = (float(loss0), float(loss1), grads,
                     [p.detach().cpu() for p in wt.tree_leaves(state.params)], launched)
    card, cpu = runs["cuda"], runs["cpu"]
    assert card[4] == 2 * dims.n_audio_layer and cpu[4] == 0
    for i in (0, 1):
        assert abs(card[i] - cpu[i]) <= 1e-5 * abs(cpu[i])
    for g, h in zip(card[2], cpu[2]):
        assert (g - h).norm() <= 1e-4 * max(h.norm().item(), 1e-12)
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(card[3], cpu[3])])
    assert diffs.max().item() <= 2 * 1e-3 * 2
    assert (diffs <= 1e-3 * 1e-3 * 2).float().mean().item() >= 0.999


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32, torch.int64,
                                   torch.float16, torch.bfloat16, torch.float32],
                         ids=lambda d: str(d).split(".")[-1])
def test_device_checksum_on_the_card_equals_the_host(cuda, dtype):
    """runtime/integrity: the checksum computed on the card equals the host
    checksum of the fetched bytes, at odd sizes (a partial last word)."""
    from modular_audio_pipeline_tpu_torch.runtime.integrity import checksum_device, host_checksum

    for n in (1, 3, 7, 1001, 1 << 20 | 5):
        x = (torch.randn(n, generator=cuda, device="cuda") * 1000).to(dtype)
        host = x.cpu().contiguous().view(torch.uint8).numpy()
        assert int(checksum_device([x]).cpu()[0]) == int(host_checksum(host)), (dtype, n)


def test_zeroed_device_copy_raises(cuda):
    """A fetch whose device checksums were computed from a zeroed copy of
    the buffer never verifies."""
    from modular_audio_pipeline_tpu_torch.exceptions import FetchIntegrityError
    from modular_audio_pipeline_tpu_torch.runtime.integrity import (
        checksum_device,
        fetch_verified_many,
        put_verified_tree,
    )

    x = torch.arange(1, 1001, device="cuda", dtype=torch.int32)
    with pytest.raises(FetchIntegrityError):
        fetch_verified_many([x], checksum_device([torch.zeros_like(x)]), ["x"], retries=1)
    tree = {"w": torch.randn(33, 7).bfloat16(), "b": {"c": torch.arange(5)}}
    dev = put_verified_tree(tree, "cuda")
    assert dev["w"].device.type == "cuda" and torch.equal(dev["w"].cpu(), tree["w"])


def test_nccl_world_of_one_serves_as_without_a_mesh(cuda):
    """parallel/mesh: a world of one rank over NCCL (no torchrun), its mesh
    of size 1, and the proxy bundle's decode under it equals the unmeshed
    one, token for token."""
    from modular_audio_pipeline_tpu_torch.config import TPUConfig
    from modular_audio_pipeline_tpu_torch.parallel.mesh import build_mesh, mesh_shape
    from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend
    from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

    mesh = build_mesh(TPUConfig(mesh_shape={"data": 1}), "cuda")
    try:
        assert mesh_shape(mesh) == {"data": 1}
        assert torch.distributed.get_backend() == "nccl"
        audio = np.random.default_rng(0).standard_normal(16000 * 20).astype(np.float32) * 0.05
        bundle = str(SHIPPED_WEIGHTS / "whisper-tiny-synth-proxy")
        out = []
        for m in (None, mesh):
            b = TorchWhisperBackend("tiny", weights_path=bundle, device="cuda", mesh=m,
                                    max_decode_tokens=32)
            out.append(b.transcribe_array(audio, 16000)["segments"])
        assert out[0] == out[1]
    finally:
        torch.distributed.destroy_process_group()

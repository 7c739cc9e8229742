"""The port's Whisper training path held against the JAX package.

Same numpy inputs and the same initial parameters (numpy, JAX layout:
``jax.random`` and ``torch.Generator`` draw different numbers) go through
the JAX train step and the port's, in f32 on the CPU.

Tolerances:
- the flash kernel's VJP: the port's q/k/v gradients within 1e-5 of JAX's
  ``jax.vjp`` over its Pallas kernel in interpret mode (f32, another order
  of summation);
- the loss within 1e-5 relative, and each leaf's gradient within 1e-4 of its
  norm (the f32 drift of 2 + 2 layers, forward and backward);
- parameters after 4 Adam steps, the two-part tolerance of Adam's sign
  flips: where a gradient element is near zero, ``m / (sqrt(v) + eps)`` is
  about +-1 and gradients 1e-7 apart can move that element by +-lr in
  opposite directions. So 99.9% of the elements agree to 1e-3 of the
  learning rate per step, and the rest within 2 lr per step.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.models.whisper.config import WHISPER_DIMS
from modular_audio_pipeline_tpu.ops import attention as jax_attention
from modular_audio_pipeline_tpu.training import whisper_train as jax_wt
from modular_audio_pipeline_tpu_torch.models.whisper import model as pt_model
from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS as PT_DIMS
from modular_audio_pipeline_tpu_torch.models.whisper.convert import (
    params_from_numpy, params_to_numpy)
from modular_audio_pipeline_tpu_torch.ops import attention as pt_attention
from modular_audio_pipeline_tpu_torch.training import optim
from modular_audio_pipeline_tpu_torch.training import whisper_train as pt_wt

ROOT = Path(__file__).resolve().parents[1]
TEST_TINY = ROOT / "modular_audio_pipeline_tpu" / "weights" / "whisper-test-tiny"
DIMS = WHISPER_DIMS["test-tiny"]
PT = PT_DIMS["test-tiny"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
LR = 1e-3
STEPS = 4


def assert_adam_close(got: dict, want: dict, lr: float, steps: int):
    """Motivation of the two-part tolerance: module docstring. The share is
    taken over every element of the parameter tree."""
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k].astype(np.float32) - want[k]).ravel()
                            for k in sorted(want)])
    assert diffs.max() <= 2 * lr * steps, diffs.max()
    assert (diffs <= 1e-3 * lr * steps).mean() >= 0.999, (diffs > 1e-3 * lr * steps).sum()


# -- kernel 1's gradient -------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 32])
@pytest.mark.parametrize("route", ["function", "cpu"])
def test_flash_vjp_equals_jax_interpret(monkeypatch, hd, route):
    """JAX: ``jax.vjp`` of ``flash_attention(..., interpret=True)``, the
    Pallas kernel in interpret mode forward and the reference backward. The
    port: its ``autograd.Function`` (the card's route; the CPU has no
    kernel, so the forward's launch is bound to the plain version) and the
    CPU route (autograd through ``attention_reference``)."""
    rng = np.random.default_rng(hd)
    q, k, v, g = (rng.standard_normal((1, 2, 40, hd)).astype(np.float32) for _ in range(4))
    out_j, vjp = jax.vjp(lambda a, b, c: jax_attention.flash_attention(a, b, c, interpret=True),
                         *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(g))

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    if route == "function":
        monkeypatch.setattr(pt_attention, "_flash_launch", pt_attention.attention_reference)
        out = pt_attention._FlashAttention.apply(qt, kt, vt)
    else:
        out = pt_attention.flash_attention(qt, kt, vt)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_function_gives_only_the_gradients_asked_for(monkeypatch):
    """q alone needs a gradient: the backward returns None for k and v."""
    monkeypatch.setattr(pt_attention, "_flash_launch", pt_attention.attention_reference)
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.standard_normal((1, 1, 9, 32)), dtype=torch.float32)
               for _ in range(3))
    q.requires_grad_(True)
    pt_attention._FlashAttention.apply(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is None and v.grad is None
    ref_q = q.detach().clone().requires_grad_(True)
    pt_attention.attention_reference(ref_q, k, v).sum().backward()
    assert torch.equal(q.grad, ref_q.grad)


# -- the train step ----------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((2, DIMS.n_mels, 3000)).astype(np.float32)
    tokens = rng.integers(0, 400, (2, 24)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[:, :3] = jax_wt.IGNORE_INDEX
    targets[1, 20:] = jax_wt.IGNORE_INDEX  # a padded row end
    return mel, tokens, targets


@pytest.fixture(scope="module")
def start_params():
    return numpy_params(DIMS, seed=3)


def _torch_batch(batch):
    mel, tokens, targets = batch
    return torch.from_numpy(mel), torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()


def test_cross_entropy_loss_equals_jax(batch):
    rng = np.random.default_rng(8)
    logits = (3 * rng.standard_normal((2, 24, 50))).astype(np.float32)
    targets = np.where(batch[2] >= 0, batch[2] % 50, batch[2]).astype(np.int32)
    want = float(jax_wt.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(pt_wt.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    all_ignored = np.full_like(targets, jax_wt.IGNORE_INDEX)
    assert float(pt_wt.cross_entropy_loss(torch.from_numpy(logits),
                                          torch.from_numpy(all_ignored))) == 0.0


@pytest.fixture(scope="module")
def jax_loss_and_grads(batch, start_params):
    params = jax.tree.map(jnp.asarray, start_params)
    fn = jax.jit(jax.value_and_grad(jax_wt._forward_loss), static_argnums=1)
    return fn(params, DIMS, *map(jnp.asarray, batch))


@pytest.fixture(scope="module")
def port_loss_and_grads(batch, start_params):
    params = params_from_numpy(start_params, "cpu", torch.float32)
    leaves = pt_wt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = pt_wt._forward_loss(params, PT, *_torch_batch(batch))
    loss.backward()
    return float(loss.detach()), dict(zip(_paths(params), (p.grad for p in leaves)))


def _paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out.extend(_paths(v, f"{prefix}/{k}") if isinstance(v, dict) else [f"{prefix}/{k}"])
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def test_train_step_loss_equals_jax(jax_loss_and_grads, port_loss_and_grads):
    np.testing.assert_allclose(port_loss_and_grads[0], float(jax_loss_and_grads[0]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_train_step_gradient_of_every_leaf_equals_jax(jax_loss_and_grads, port_loss_and_grads,
                                                      part):
    want = _flat(jax_loss_and_grads[1])
    got = port_loss_and_grads[1]
    keys = [k for k in want if k.startswith(f"/{part}")]
    assert keys and set(keys) <= set(got)
    for key in keys:
        g, w = got[key].numpy(), want[key]
        scale = max(np.linalg.norm(w), 1e-12)
        assert np.linalg.norm(g - w) <= GRAD_REL * scale, (key, np.linalg.norm(g - w) / scale)
    # the encoder's attention projections get a gradient through the flash route
    if part == "encoder":
        assert np.abs(got["/encoder/blocks/attn/q_w"].numpy()).max() > 0


def test_params_after_four_adamw_steps_equal_jax(batch, start_params):
    jinit, jstep = jax_wt.make_train_step(DIMS, optax.adamw(LR, weight_decay=0.01))
    jstate = jinit(jax.tree.map(jnp.asarray, start_params))
    step = jax.jit(jstep)
    pinit, pstep = pt_wt.make_train_step(PT, optim.adamw(LR, weight_decay=0.01))
    pstate = pinit(params_from_numpy(start_params, "cpu", torch.float32))
    tb = _torch_batch(batch)
    for i in range(STEPS):
        jstate, jloss = step(jstate, *map(jnp.asarray, batch))
        pstate, ploss = pstep(pstate, *tb)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    assert pstate.step == STEPS and int(jstate.step) == STEPS
    want = _flat(jstate.params)
    got = _flat(params_to_numpy(pstate.params))
    assert set(got) == set(want)
    assert_adam_close(got, want, LR, STEPS)


def test_loss_decreases_on_fixed_batch(batch):
    """The JAX package's test_loss_decreases_on_fixed_batch, mirrored: the
    port's random test-tiny init and the default AdamW (lr 1e-5)."""
    params = pt_model.init_params(PT, torch.Generator().manual_seed(0), torch.float32)
    init_state, train_step = pt_wt.make_train_step(PT)
    state = init_state(params)
    losses = []
    for _ in range(4):
        state, loss = train_step(state, *_torch_batch(batch))
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"


def test_teacher_forced_logits_bit_equal_with_and_without_autograd(start_params, batch):
    """The decoder attends to copies of the cache only while autograd
    records; inference reads the cache itself, and the values are equal."""
    params = params_from_numpy(start_params, "cpu", torch.float32)
    mel, tokens, _ = _torch_batch(batch)
    with torch.no_grad():
        xa = pt_model.encoder_forward(params, PT, mel)
        xk, xv = pt_model.cross_kv(params, PT, xa)
        cache = pt_model.KVCache.zeros(PT, 2, torch.float32, ctx=tokens.shape[1])
        plain, _ = pt_model.decoder_forward(params, PT, tokens, xk, xv, cache)
    for p in pt_wt.tree_leaves(params):
        p.requires_grad_(True)
    cache2 = pt_model.KVCache.zeros(PT, 2, torch.float32, ctx=tokens.shape[1])
    graded, _ = pt_model.decoder_forward(params, PT, tokens, xk, xv, cache2)
    assert graded.requires_grad
    assert torch.equal(graded.detach(), plain)
    assert torch.equal(cache2.k.detach(), cache.k) and cache2.pos == cache.pos


# -- the CLI and the proxy recipe -------------------------------------------------

def _clips(tmp_path, n=3, seconds=2.0):
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav

    rng = np.random.default_rng(11)
    rows = []
    for i in range(n):
        path = tmp_path / f"clip{i}.wav"
        write_wav(str(path), (0.1 * rng.standard_normal(int(16000 * seconds))).astype(np.float32),
                  16000)
        rows.append({"audio": str(path), "text": f"alpha bravo {i}", "duration": seconds})
    manifest = tmp_path / "train.jsonl"
    manifest.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return manifest


def test_train_cli_end_to_end_equals_jax_and_saves_jax_layout(tmp_path):
    """``training.train.main`` on 3 clips for one epoch (two batches of 2:
    the second is padded with an IGNORE row) from the shipped test-tiny bundle, against
    the JAX train step over the JAX dataset; the saved ``params.npz`` loads
    in the JAX package."""
    from modular_audio_pipeline_tpu.models.whisper.convert import load_params as jax_load
    from modular_audio_pipeline_tpu.models.whisper.tokenizer import load_tokenizer
    from modular_audio_pipeline_tpu.training.data import TranscriptDataset
    from modular_audio_pipeline_tpu_torch.training import train

    manifest = _clips(tmp_path)
    out = tmp_path / "out"
    lr = 1e-4
    train.main(["--manifest", str(manifest), "--model", "test-tiny", "--weights", str(TEST_TINY),
                "--out", str(out), "--epochs", "1", "--batch-size", "2", "--seq-len", "32",
                "--lr", str(lr)], device="cpu")

    start = jax_load(str(TEST_TINY), dtype=jnp.float32)
    ds = TranscriptDataset.from_manifest(str(manifest), load_tokenizer(str(TEST_TINY), 51865),
                                         DIMS, batch_size=2, seq_len=32)
    init_state, train_step = jax_wt.make_train_step(DIMS, optax.adamw(lr, weight_decay=0.01))
    state = init_state(jax.tree.map(jnp.asarray, start))
    step = jax.jit(train_step)
    n = 0
    for mel, tokens, targets in ds.batches(epoch=0):
        state, _ = step(state, jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(targets))
        n += 1
    assert n == 2
    saved = jax_load(str(out))
    want = _flat(jax.tree.map(np.asarray, state.params))
    got = _flat(saved)
    assert set(got) == set(want)
    assert all(v.dtype == np.float32 for v in got.values())
    assert_adam_close(got, want, lr, n)


def test_train_cli_refuses_more_than_one_card(tmp_path):
    """``--devices``/``--tp`` build the (data, model) mesh of the JAX
    train.py; in a world of one process (no torchrun) a mesh of two cards
    raises ``ShardingError`` before anything loads."""
    from modular_audio_pipeline_tpu_torch.exceptions import ShardingError
    from modular_audio_pipeline_tpu_torch.training import train

    manifest = _clips(tmp_path, n=1)
    for flag in (["--devices", "2"], ["--tp", "2"]):
        with pytest.raises(ShardingError, match="torchrun"):
            train.main(["--manifest", str(manifest), "--model", "test-tiny", "--weights",
                        "random:0", "--out", str(tmp_path / "o")] + flag, device="cpu")


def test_train_proxy_from_the_test_tiny_bundle_equals_jax(tmp_path):
    """``synth_asr.train_proxy(init_from=weights/whisper-test-tiny)``: two
    epochs of two batches (the second epoch reads the float16 mel cache),
    warm-up cosine AdamW, float16 checkpoint with the byte-tokenizer marker;
    the saved checkpoints agree within one float16 ulp where the f32
    parameters do under the two-part tolerance."""
    from modular_audio_pipeline_tpu.models.whisper.convert import load_params as jax_load
    from modular_audio_pipeline_tpu.training import synth_asr as jax_sa
    from modular_audio_pipeline_tpu_torch.training import synth_asr as pt_sa

    train_m, _ = jax_sa.make_dataset(str(tmp_path / "data"), n_train=3, n_eval=1, seed=4)
    kw = dict(epochs=2, batch_size=2, seq_len=64, lr=3e-4, model_name="test-tiny",
              init_from=str(TEST_TINY))
    want = jax_sa.train_proxy(train_m, str(tmp_path / "jax"), **kw)
    got = pt_sa.train_proxy(train_m, str(tmp_path / "port"), device="cpu", **kw)
    assert set(got) == set(want) and got["epochs"] == 2
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    assert (tmp_path / "port" / "byte_tokenizer.json").read_text() == \
        (tmp_path / "jax" / "byte_tokenizer.json").read_text()
    a, b = _flat(jax_load(str(tmp_path / "port"))), _flat(jax_load(str(tmp_path / "jax")))
    assert set(a) == set(b)
    for key in b:
        assert a[key].dtype == np.float16 == b[key].dtype
        # float16 rounding of values within the Adam tolerance: one f16 ulp
        # of the larger magnitude, or the two-part bound
        gap = np.abs(a[key].astype(np.float32) - b[key].astype(np.float32))
        ulp = np.spacing(np.maximum(np.abs(a[key]), np.abs(b[key])).astype(np.float16))
        assert (gap <= np.maximum(ulp.astype(np.float32), 2 * 3e-4 * 4)).all(), key

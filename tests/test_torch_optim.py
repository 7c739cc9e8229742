"""The port's optimizers, schedules and losses held against optax.

``training/optim.py`` is the port's copy of the optax pieces the JAX
trainers use. The same numpy gradients (from a seed) drive optax and the
port for 10 updates of each optimizer and schedule. The gradients are
equal inputs here, so no Adam sign flip can occur (that needs gradients
that differ near zero, ``tests/test_torch_training.py``): parameters agree
to one f32 ulp of the parameter per update (2^-23 of the largest |p|),
the rounding of ``p + update`` after f32 arithmetic in another order.
Schedules agree to 1e-6 of their peak value (optax evaluates them in f32,
the port in f64; near the end of a cosine the relative error of f32 grows). Losses and their gradients agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modular_audio_pipeline_tpu_torch.training import optim

STEPS = 10
SCHED_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several pytest workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


COSINE_CASES = [(1e-3, 20, 0.0, 1.0), (3e-4, 7, 0.1, 1.0), (1.0, 13, 0.05, 2.0)]


@pytest.mark.parametrize("init, steps, alpha, exponent", COSINE_CASES)
def test_cosine_decay_schedule_equals_optax(init, steps, alpha, exponent):
    ref = optax.cosine_decay_schedule(init, steps, alpha, exponent)
    mine = optim.cosine_decay_schedule(init, steps, alpha, exponent)
    for t in range(steps + 5):  # past decay_steps the value holds at alpha * init
        np.testing.assert_allclose(mine(t), float(ref(t)), rtol=0, atol=SCHED_RTOL * init)


WARMUP_CASES = [(0.0, 3e-4, 10, 100, 0.0), (0.0, 1e-3, 0, 8, 5e-5), (1e-5, 1e-3, 3, 12, 1e-4),
                (0.0, 1e-3, 1, 2, 0.0)]


@pytest.mark.parametrize("init, peak, warmup, decay, end", WARMUP_CASES)
def test_warmup_cosine_decay_schedule_equals_optax(init, peak, warmup, decay, end):
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    mine = optim.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    for t in range(decay + 4):
        np.testing.assert_allclose(mine(t), float(ref(t)), rtol=0, atol=SCHED_RTOL * peak)


def test_cosine_decay_needs_positive_steps():
    with pytest.raises(ValueError):
        optax.cosine_decay_schedule(1e-3, 0)
    with pytest.raises(ValueError):
        optim.cosine_decay_schedule(1e-3, 0)


def _shapes():
    return [(7, 5), (5,), (3, 2, 4), (1,)]


def _run_both(make_optax, make_port, missing=None):
    """10 updates of optax and of the port from the same start and the same
    gradients; returns the largest parameter difference in f32 ulps of the
    largest parameter after each update, and the final parameters."""
    rng = np.random.default_rng(0)
    start = [rng.standard_normal(s).astype(np.float32) for s in _shapes()]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
              for s in _shapes()] for _ in range(STEPS)]
    if missing is not None:  # this leaf gets no gradient (a zero gradient in optax)
        for g in grads:
            g[missing] = np.zeros_like(g[missing])

    tx = make_optax()
    jp = [jnp.asarray(a) for a in start]
    st = tx.init(jp)
    tp = [torch.tensor(a) for a in start]
    state = make_port().init(tp)
    worst = []
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for i, (p, x) in enumerate(zip(tp, g)):
            p.grad = None if i == missing else torch.tensor(x)
        state.step()
        ulp = 2.0**-23 * max(float(np.abs(np.asarray(a)).max()) for a in jp)
        worst.append(max(float(np.abs(np.asarray(a) - b.numpy()).max()) for a, b in zip(jp, tp))
                     / ulp)
    return worst, [np.asarray(a) for a in jp], [b.numpy() for b in tp], start


OPT_CASES = {
    "adam_constant": (lambda: optax.adam(1e-3), lambda: optim.adam(1e-3), 1e-3),
    "adam_cosine": (lambda: optax.adam(optax.cosine_decay_schedule(3e-4, STEPS)),
                    lambda: optim.adam(optim.cosine_decay_schedule(3e-4, STEPS)), 3e-4),
    "adamw_constant": (lambda: optax.adamw(1e-2, weight_decay=0.01),
                       lambda: optim.adamw(1e-2, weight_decay=0.01), 1e-2),
    "adamw_warmup_cosine": (
        lambda: optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, STEPS),
                            weight_decay=0.01),
        lambda: optim.adamw(optim.warmup_cosine_decay_schedule(0.0, 1e-3, 3, STEPS),
                            weight_decay=0.01), 1e-3),
    "adam_warmup_cosine_end": (
        lambda: optax.adam(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, STEPS, 5e-5)),
        lambda: optim.adam(optim.warmup_cosine_decay_schedule(0.0, 1e-3, 1, STEPS, 5e-5)),
        1e-3),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_ten_steps_equal_optax(case):
    make_optax, make_port, lr = OPT_CASES[case]
    worst, _, _, _ = _run_both(make_optax, make_port)
    for i, w in enumerate(worst):  # one ulp per update at most
        assert w <= i + 1, worst


def test_warmup_from_zero_makes_the_first_update_zero():
    """optax reads the schedule at the count before it increments it."""
    make_optax, make_port, lr = OPT_CASES["adamw_warmup_cosine"]
    rng = np.random.default_rng(1)
    start = [rng.standard_normal(s).astype(np.float32) for s in _shapes()]
    tp = [torch.tensor(a) for a in start]
    state = make_port().init(tp)
    for p in tp:
        p.grad = torch.ones_like(p)
    state.step()
    for a, b in zip(start, tp):
        assert np.array_equal(a, b.numpy())
    assert state.count == 1
    state.step()  # the second update moves them
    assert not np.array_equal(start[0], tp[0].numpy())


def test_weight_decay_reaches_every_leaf_and_a_missing_gradient_is_zero():
    """adamw decays biases and norms too; a leaf without a gradient moves
    by the decay alone, as a zero gradient in optax."""
    make_optax, make_port, lr = OPT_CASES["adamw_constant"]
    worst, jp, tp, start = _run_both(make_optax, make_port, missing=1)
    assert all(w <= i + 1 for i, w in enumerate(worst)), worst
    # the leaf with no gradient shrank by the decay alone: (1 - lr wd)^10
    np.testing.assert_allclose(tp[1], start[1] * (1 - 1e-2 * 0.01) ** STEPS, rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 7), (2, 3, 11)])
def test_softmax_cross_entropy_and_gradient_equal_optax(shape):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    labels = rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(np.float32)
    ref, g_ref = jax.value_and_grad(
        lambda x: optax.softmax_cross_entropy(x, jnp.asarray(labels)).sum())(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    out = optim.softmax_cross_entropy(x, torch.tensor(labels))
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(optax.softmax_cross_entropy(logits, labels)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(out.sum().detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_sigmoid_binary_cross_entropy_and_gradient_equal_optax(scale):
    """Large logits included: the loss must not overflow where optax does not."""
    rng = np.random.default_rng(3)
    logits = (scale * rng.standard_normal((6, 125))).astype(np.float32)
    labels = (rng.random((6, 125)) > 0.5).astype(np.float32)
    ref, g_ref = jax.value_and_grad(
        lambda x: optax.sigmoid_binary_cross_entropy(x, jnp.asarray(labels)).mean())(
            jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    out = optim.sigmoid_binary_cross_entropy(x, torch.tensor(labels)).mean()
    out.backward()
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), rtol=1e-6, atol=1e-9)

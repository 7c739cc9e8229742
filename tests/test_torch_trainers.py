"""The port's VAD, diarization and separation trainers held against the JAX
package.

The synthetic data is host numpy and must be equal. Each trainer runs 2-3
steps in both packages from the same initial parameters (numpy in the JAX
layout: the JAX trainer's ``init_params`` is bound to them for the test,
the port takes them as an argument), and the saved checkpoints are held to
the two-part tolerance of Adam's sign flips (``tests/test_torch_training.py``):
99.9% of the elements within 1e-3 of the learning rate per step, all within
2 lr per step. Losses agree to 1e-4 relative (f32 through convolutions,
FFTs and the flash route in another order). The evaluations and the
calibration are in ``tests/test_torch_trainer_evaluation.py``.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.models.diarization.embedding import ConvEmbedder as JaxEmbedder
from modular_audio_pipeline_tpu.models.diarization.segmentation import (
    SegmentationNet as JaxSegNet)
from modular_audio_pipeline_tpu.models.separation import unet as jax_unet
from modular_audio_pipeline_tpu.models.vad_net import ConvVAD as JaxVAD
from modular_audio_pipeline_tpu.models.whisper.convert import load_params
from modular_audio_pipeline_tpu.training import diarization as jax_diar
from modular_audio_pipeline_tpu.training import separation as jax_sep
from modular_audio_pipeline_tpu.training import vad as jax_vad
from modular_audio_pipeline_tpu_torch.models.diarization.embedding import ConvEmbedder
from modular_audio_pipeline_tpu_torch.models.diarization.segmentation import SegmentationNet
from modular_audio_pipeline_tpu_torch.models.separation import unet as pt_unet
from modular_audio_pipeline_tpu_torch.models.vad_net import ConvVAD
from modular_audio_pipeline_tpu_torch.training import diarization as pt_diar
from modular_audio_pipeline_tpu_torch.training import separation as pt_sep
from modular_audio_pipeline_tpu_torch.training import vad as pt_vad

WEIGHTS = Path(__file__).resolve().parents[1] / "modular_audio_pipeline_tpu" / "weights"
LOSS_RTOL = 1e-4

MODULES = {
    "vad": (ConvVAD, JaxVAD, "vad-silero"),
    "embedding": (ConvEmbedder, JaxEmbedder, "diarization-embedding"),
    "segmentation": (SegmentationNet, JaxSegNet, "diarization-segmentation"),
    "separation": (pt_unet.MaskUNet, jax_unet.MaskUNet, "separation-htdemucs"),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}") if isinstance(v, dict)
                   else {f"{prefix}/{k}": np.asarray(v)})
    return out


def assert_adam_close(got: dict, want: dict, lr: float, steps: int, share: float = 0.999):
    """The share is taken over every element of the checkpoint."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in sorted(want)])
    assert diffs.max() <= 2 * lr * steps, diffs.max()
    assert (diffs <= 1e-3 * lr * steps).mean() >= share, (diffs > 1e-3 * lr * steps).sum()


# -- the JAX layout ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODULES))
def test_jax_layout_round_trips_bit_for_bit(name):
    """Shipped bundle -> the port's module -> ``numpy_params``: every leaf
    equal in value, shape and type, and no leaf added or lost."""
    cls, _, bundle = MODULES[name]
    params = load_params(str(WEIGHTS / bundle))
    back = cls(params, device="cpu").numpy_params()
    a, b = _flat(back), _flat(params)
    assert set(a) == set(b)
    for key in b:
        assert a[key].dtype == np.float32 and a[key].shape == b[key].shape, key
        assert np.array_equal(a[key], b[key].astype(np.float32)), key


@pytest.mark.parametrize("name", sorted(MODULES))
def test_init_params_have_the_jax_tree(name):
    """The port draws other numbers (a torch.Generator) into the JAX tree's
    shapes: zero biases, unit norm gains, weights of the fan-in scale, and
    the same numbers for the same seed."""
    cls, jcls, _ = MODULES[name]
    theirs = jax.tree_util.tree_leaves_with_path(jax.eval_shape(lambda: jcls.init_params(0)))
    theirs = {"".join(f"/{k.key}" for k in path): leaf for path, leaf in theirs}
    mine = _flat(cls.init_params(0))
    assert set(mine) == set(theirs)
    for key, want in theirs.items():
        leaf = mine[key]
        assert leaf.shape == want.shape and leaf.dtype == np.float32, key
        if key.endswith("/b"):
            assert not leaf.any(), key
        elif key.endswith("/g"):
            assert (leaf == 1).all(), key
        else:  # normal draws scaled by fan_in^-0.5: fan_in * var ~ 1
            # matrices [(L,) in, out]; convolutions [out, in, *width]
            matrix = leaf.ndim == 2 or "/blocks/" in key
            fan_in = leaf.shape[-2] if matrix else leaf[0].size
            assert 0.5 < fan_in * leaf.var() < 2.0, (key, fan_in * leaf.var())
    again = _flat(cls.init_params(0))
    assert all(np.array_equal(mine[k], again[k]) for k in mine)


# -- host data --------------------------------------------------------------------------

def test_vad_clips_bit_equal():
    a = jax_vad.build_dataset(6, seed=4, n_speakers=3)
    b = pt_vad.build_dataset(6, seed=4, n_speakers=3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_diarization_batches_scenes_and_labels_bit_equal():
    va, ra = jax_diar._speaker_pool(6, 2)
    vb, rb = pt_diar._speaker_pool(6, 2)
    for x, y in zip(jax_diar._embedder_batch(va, ra, 3, 2), pt_diar._embedder_batch(vb, rb, 3, 2)):
        assert np.array_equal(x, y)
    for x, y in zip(jax_diar._synth_scene(np.random.default_rng(5), 998),
                    pt_diar._synth_scene(np.random.default_rng(5), 998)):
        assert np.array_equal(x, y)
    act = np.random.default_rng(6).integers(0, 2, (50, 3))
    act[act.sum(axis=1) > 2, 2] = 0
    labels = pt_diar._perm_class_labels(act)
    assert labels.shape == (6, 50) and np.array_equal(labels, jax_diar._perm_class_labels(act))
    for (a, ta, na), (b, tb, nb) in zip(jax_diar._held_out_conversations(1, 2),
                                        pt_diar._held_out_conversations(1, 2)):
        assert np.array_equal(a, b) and ta == tb and na == nb


def test_separation_mixtures_and_si_snr_equal():
    for x, y in zip(jax_sep._mixture_batch(np.random.default_rng(3), 2, seconds=2.0),
                    pt_sep._mixture_batch(np.random.default_rng(3), 2, seconds=2.0)):
        assert np.array_equal(x, y)
    assert np.array_equal(jax_sep.synth_music(np.random.default_rng(4), 1.5),
                          pt_sep.synth_music(np.random.default_rng(4), 1.5))
    rng = np.random.default_rng(5)
    t = rng.standard_normal(800).astype(np.float32)
    e = (t + 0.3 * rng.standard_normal(800)).astype(np.float32)
    assert pt_sep.si_snr(e, t) == jax_sep.si_snr(e, t)


@pytest.mark.parametrize("loss", ["masking_loss", "dual_stem_loss"])
def test_maskunet_losses_and_gradients_equal_jax(loss):
    params = load_params(str(WEIGHTS / "separation-htdemucs"))
    rng = np.random.default_rng(8)
    mags = [np.abs(rng.standard_normal((1, 40, 21))).astype(np.float32) for _ in range(3)]
    n_args = 2 if loss == "masking_loss" else 3
    jp = jax.tree.map(jnp.asarray, params)
    want, g_want = jax.jit(jax.value_and_grad(getattr(jax_unet, loss)))(
        jp, *(jnp.asarray(m) for m in mags[:n_args]))
    net = pt_unet.MaskUNet(params, device="cpu").requires_grad_(True)
    got = getattr(pt_unet, loss)(net, *(torch.from_numpy(m) for m in mags[:n_args]))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for name, g in _flat(jax.tree.map(np.asarray, g_want)).items():
        _, leaf, part = name.split("/")
        mine = getattr(net, f"{leaf}_{part}").grad.numpy()
        assert np.linalg.norm(mine - g) <= 1e-4 * max(np.linalg.norm(g), 1e-12), name


# -- the trainers ------------------------------------------------------------------------

def _bind_jax_init(monkeypatch, jcls, params):
    monkeypatch.setattr(jcls, "init_params", staticmethod(lambda seed=0: params))


def test_train_vad_equals_jax(tmp_path, monkeypatch):
    start = load_params(str(WEIGHTS / "vad-silero"))
    _bind_jax_init(monkeypatch, JaxVAD, start)
    # a small held-out evaluation after training
    monkeypatch.setattr(jax_vad, "evaluate_vad", functools.partial(jax_vad.evaluate_vad,
                                                                   n_clips=4))
    kw = dict(steps=3, batch_size=4, n_train_clips=6, seed=2, lr=3e-4)
    want = jax_vad.train_vad(str(tmp_path / "jax"), **kw)
    losses = []
    got = pt_vad.train_vad(str(tmp_path / "port"), params=start, device="cpu", eval_clips=4,
                           on_step=lambda i, loss: losses.append(float(loss)), **kw)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert_adam_close(load_params(str(tmp_path / "port" / "vad-silero")),
                      load_params(str(tmp_path / "jax" / "vad-silero")), 3e-4, 3)
    assert set(got) == set(want) and got["held_out_clips"] == want["held_out_clips"] == 4
    for key in want:  # window decisions of near-equal parameters: within 1% of the windows
        assert abs(got[key] - want[key]) <= 0.01 * max(1.0, abs(want[key])), key
    cal = json.loads((tmp_path / "port" / "vad-silero" / "calibration.json").read_text())
    assert cal == got


def test_train_embedder_equals_jax(tmp_path, monkeypatch):
    start = load_params(str(WEIGHTS / "diarization-embedding"))
    _bind_jax_init(monkeypatch, JaxEmbedder, start)
    kw = dict(n_speakers=6, steps=2, batch_speakers=3, utts_per_speaker=2, seed=1)
    cls = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (192, 6)) * 0.05)
    want = jax_diar.train_embedder(str(tmp_path / "jax"), **kw)
    got = pt_diar.train_embedder(str(tmp_path / "port"), params={"net": start, "cls": cls},
                                 device="cpu", **kw)
    assert set(got) == set(want) and got["steps"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["train_acc"] == want["train_acc"]
    assert_adam_close(load_params(str(tmp_path / "port")), load_params(str(tmp_path / "jax")),
                      1e-3, 2)


def test_train_segmentation_equals_jax(tmp_path, monkeypatch):
    """SegmentationNet through the flash route (the plain version on the
    CPU) with the permutation-invariant loss."""
    start = load_params(str(WEIGHTS / "diarization-segmentation"))
    _bind_jax_init(monkeypatch, JaxSegNet, start)
    kw = dict(steps=2, batch=2, seed=3)
    want = jax_diar.train_segmentation(str(tmp_path / "jax"), **kw)
    got = pt_diar.train_segmentation(str(tmp_path / "port"), params=str(WEIGHTS /
                                     "diarization-segmentation"), device="cpu", **kw)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert abs(got["frame_acc"] - want["frame_acc"]) <= 1e-3
    assert_adam_close(load_params(str(tmp_path / "port")), load_params(str(tmp_path / "jax")),
                      8e-4, 2)


def test_train_separator_equals_jax(tmp_path, monkeypatch):
    start = load_params(str(WEIGHTS / "separation-htdemucs"))
    _bind_jax_init(monkeypatch, jax_unet.MaskUNet, start)
    # short clips: the CPU's convolutions over 6 s spectrograms would dominate
    for mod in (jax_sep, pt_sep):
        monkeypatch.setattr(mod, "_CLIP_S", 2.0)
        monkeypatch.setattr(mod, "_mixture_batch",
                            functools.partial(mod._mixture_batch, seconds=2.0))
    kw = dict(steps=2, batch=2, seed=4)
    want = jax_sep.train_separator(str(tmp_path / "jax"), **kw)
    got = pt_sep.train_separator(str(tmp_path / "port"), params=start, device="cpu", **kw)
    assert set(got) == set(want) and got["steps"] == 2
    np.testing.assert_allclose(got["l1"], want["l1"], rtol=LOSS_RTOL)
    # the L1 loss's gradient is the sign of each residual, and residuals
    # near zero are common, so Adam's flips reach more elements: 0.16% of
    # the 2.7 M after two steps; 99.5% are held to the tight bound
    assert_adam_close(load_params(str(tmp_path / "port")), load_params(str(tmp_path / "jax")),
                      1e-3, 2, share=0.995)


def test_trainers_draw_their_own_init_when_given_none(tmp_path):
    """Without initial parameters a trainer draws from its seed (a
    torch.Generator): the same seed gives the same checkpoint."""
    runs = []
    for d in ("a", "b"):
        pt_diar.train_segmentation(str(tmp_path / d), steps=1, batch=1, seed=5, device="cpu")
        runs.append(_flat(load_params(str(tmp_path / d))))
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])

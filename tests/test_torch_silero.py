"""The converted Silero VAD of the port held against the JAX package on
the CPU: the state_dict conversion, the graph's probabilities, the LSTM
state carried across a split, ``load_vad_model`` and the serving path's
600 s section loop.

No Silero bundle ships (its weights come from torch.hub), so the weights
are a random state_dict of the published v5 layout with a DFT basis, made
from a numpy seed. Probabilities agree to 1e-5 (f32 convolutions and the
recurrence summed in another order); keep intervals, segments and JSON
are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import make_audio
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.models import silero_convert as jax_convert
from modular_audio_pipeline_tpu.models.vad_net import SileroVAD as JaxSileroVAD
from modular_audio_pipeline_tpu_torch.models import silero_convert as pt_convert
from modular_audio_pipeline_tpu_torch.models.vad_net import SileroVAD

SR = 16000
PROB_TOL = 1e-5


def synthetic_state_dict(seed=0):
    """A state_dict of the published v5 layout: random weights scaled by
    fan-in, and a DFT basis (real rows, then imaginary rows)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in pt_convert.EXPECTED_SHAPES.items():
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        sd[key] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    n_fft = 256
    k = np.arange(129)[:, None]
    n = np.arange(n_fft)[None, :]
    sd["_model.stft.forward_basis_buffer"] = np.concatenate(
        [np.cos(2 * np.pi * k * n / n_fft), -np.sin(2 * np.pi * k * n / n_fft)]
    )[:, None, :].astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def models():
    tree = pt_convert.convert_state_dict(synthetic_state_dict())
    return JaxSileroVAD(jax_convert.convert_state_dict(synthetic_state_dict())), SileroVAD(
        tree, device="cpu")


def test_converted_tree_equals_jax():
    sd = synthetic_state_dict(1)
    got, want = pt_convert.convert_state_dict(sd), jax_convert.convert_state_dict(sd)
    assert pt_convert.EXPECTED_SHAPES == jax_convert.EXPECTED_SHAPES
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys()
        for leaf in want[k]:
            assert got[k][leaf].dtype == np.float32
            np.testing.assert_array_equal(got[k][leaf], want[k][leaf])
    assert pt_convert.is_silero_tree(got) and not pt_convert.is_silero_tree({"conv1": {}})
    # torch tensors convert as numpy arrays do
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    np.testing.assert_array_equal(pt_convert.convert_state_dict(tsd)["rnn"]["w_hh"],
                                  want["rnn"]["w_hh"])


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_bad_state_dict_raises(fault):
    sd = synthetic_state_dict()
    if fault == "missing":
        del sd["_model.decoder.rnn.weight_hh"]
    else:
        sd["_model.encoder.0.reparam_conv.weight"] = np.zeros((64, 129, 3), np.float32)
    with pytest.raises(ValueError, match="missing key" if fault == "missing" else "shape"):
        pt_convert.convert_state_dict(sd)


def test_convert_writes_the_jax_bundle(tmp_path):
    """convert() on a saved state_dict writes the npz the JAX converter
    writes."""
    sd = synthetic_state_dict(2)
    src = tmp_path / "silero.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    pt_convert.convert(str(src), str(tmp_path / "pt"))
    jax_convert.convert(str(src), str(tmp_path / "jax"))
    with np.load(tmp_path / "pt" / "params.npz") as a, \
            np.load(tmp_path / "jax" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("signal", ["speech", "noise", "resampled"])
def test_speech_probs_equal_jax(models, signal):
    jm, pm = models
    rng = np.random.default_rng(4)
    if signal == "noise":
        audio, sr = (0.1 * rng.standard_normal(SR * 6)).astype(np.float32), SR
    elif signal == "speech":
        audio, sr = make_audio(12.0), SR
    else:
        audio, sr = make_audio(6.0)[::2].copy(), 8000
    want = jm.speech_probs(audio, sr)
    got = pm.speech_probs(audio, sr)
    assert got.shape == want.shape and got.dtype == np.float32
    assert len(got) == (len(audio) * SR // sr) // 512
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    assert want.std() > 1e-3  # the probabilities move


def test_run_carry_across_a_split_equals_jax(models):
    """The state out of the first part seeds the second: equal to one run
    over the whole sequence, and to the JAX package's run_carry."""
    jm, pm = models
    audio = make_audio(8.0, seed=3)
    n = (len(audio) // 512) * 512
    frames = audio[:n].reshape(-1, 512)
    ctx = np.zeros((frames.shape[0], 64), np.float32)
    ctx[1:] = frames[:-1, -64:]
    chunks = np.concatenate([ctx, frames], axis=1)
    zero = torch.zeros(128)
    whole, h_w, c_w = pm.run_carry(torch.from_numpy(chunks), zero, zero)
    split = 97
    p1, h, c = pm.run_carry(torch.from_numpy(chunks[:split]), zero, zero)
    p2, h, c = pm.run_carry(torch.from_numpy(chunks[split:]), h, c)
    np.testing.assert_allclose(torch.cat([p1, p2]).numpy(), whole.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), h_w.numpy(), rtol=0, atol=1e-6)
    jz = jnp.zeros(128)
    jp1, jh, jc = JaxSileroVAD.run_carry(jm.params, jnp.asarray(chunks[:split]), jz, jz)
    jp2, jh, jc = JaxSileroVAD.run_carry(jm.params, jnp.asarray(chunks[split:]), jh, jc)
    np.testing.assert_allclose(torch.cat([p1, p2]).numpy(),
                               np.concatenate([np.asarray(jp1), np.asarray(jp2)]),
                               rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=PROB_TOL)


@pytest.fixture()
def silero_root(tmp_path, monkeypatch):
    """A weights root holding only a converted Silero bundle."""
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import flatten_tree

    bundle = tmp_path / "vad-silero"
    bundle.mkdir()
    np.savez(bundle / "params.npz",
             **flatten_tree(pt_convert.convert_state_dict(synthetic_state_dict())))
    monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path))
    return tmp_path


def test_load_vad_model_loads_silero(silero_root):
    from modular_audio_pipeline_tpu_torch.vad import load_vad_model

    model, threshold = load_vad_model(device="cpu")
    assert isinstance(model, SileroVAD) and threshold == 0.5
    (silero_root / "vad-silero" / "calibration.json").write_text('{"threshold": 0.4}')
    assert load_vad_model(device="cpu")[1] == 0.4
    assert load_vad_model(0.7, device="cpu")[1] == 0.7


@pytest.mark.parametrize("section_s", [600, 25])
def test_serving_with_a_silero_bundle_equals_jax(silero_root, monkeypatch, section_s):
    """ServingPipeline on test-tiny with the Silero bundle as the only
    bundle (so no diarization and the energy fallback nowhere): keep
    intervals, decode and segments equal to the JAX package's, in one DSP
    section and with 25 s sections over the 70 s file (the LSTM state and
    the 64-sample context carried across)."""
    from test_torch_serving import assert_equal_results, pair

    from modular_audio_pipeline_tpu import serving as jax_serving
    from modular_audio_pipeline_tpu_torch import serving as pt_serving

    def edit(cfg):
        cfg.noise_reduction.enabled = False  # per-section noise profiles differ by design
        cfg.vad.threshold = 0.45

    monkeypatch.setattr(jax_serving, "_DSP_SECTION_S", section_s)
    monkeypatch.setattr(pt_serving, "_DSP_SECTION_S", section_s)
    jp, pp = pair(tokens=8, words=False, diarize=False, edit=edit)
    audio = make_audio(70.0, seed=1)
    want = jp.process(audio, SR)
    got = pp.process(audio, SR)
    assert isinstance(pp._vad_model, SileroVAD)
    assert type(jp._vad_model).__name__ == "SileroVAD"
    assert want["timestamp_mappings"] and 0 < want["kept_duration"] < 70.0
    assert_equal_results(got, want)

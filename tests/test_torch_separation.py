"""Vocal separation of the port held against the JAX package on the CPU:
the music auto-detect (``ops/music.py``), REPET, the MaskUNet, backend
resolution and the file-to-file ``VocalSeparator``.

The same numpy inputs go through both packages. Decisions and periods are
equal; the energy CV agrees to 1e-5; MaskUNet masks and stems to 1e-5
(f32 convolutions summed in another order); REPET stems to 1e-5 (its
period and median model are the same, the FFTs differ in rounding); stems
written as 16-bit WAV files by both stages to one quantisation step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.models.separation import repet as jax_repet
from modular_audio_pipeline_tpu.models.separation.unet import MaskUNet as JaxMaskUNet
from modular_audio_pipeline_tpu.ops import bucketing as jax_bucketing
from modular_audio_pipeline_tpu.ops import music as jax_music
from modular_audio_pipeline_tpu_torch.models.separation import repet as pt_repet
from modular_audio_pipeline_tpu_torch.models.separation.unet import MaskUNet
from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params
from modular_audio_pipeline_tpu_torch.ops import bucketing as pt_bucketing
from modular_audio_pipeline_tpu_torch.ops import music as pt_music
from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

SR = 16000
BUNDLE = SHIPPED_WEIGHTS / "separation-htdemucs"


def music_mix(seconds=12.0):
    """A repeating two-tone bed under a vibrato voice gated at 0.9 Hz (the
    JAX package's serving separation tests' mix)."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    loop = 0.3 * np.sin(2 * np.pi * 98 * t) + 0.2 * np.sin(2 * np.pi * 196.5 * t)
    vox_env = (np.sin(2 * np.pi * 0.9 * t) > 0).astype(np.float32)
    vox = 0.25 * np.sin(2 * np.pi * 440 * t + 3 * np.sin(2 * np.pi * 5 * t)) * vox_env
    return (loop + vox).astype(np.float32)


def speech(seconds=12.0):
    from test_serving import make_audio

    return make_audio(seconds)


# -- music auto-detect --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["music", "speech", "short"])
def test_analyze_audio_content_equal_jax(kind):
    """Equal decisions and confidences, the CV to 1e-5; the device form
    over the padded waveform gives the host form's decision."""
    audio = {"music": music_mix(), "speech": speech(), "short": music_mix(0.4)}[kind]
    want = jax_music.analyze_audio_content(audio, SR)
    got = pt_music.analyze_audio_content(audio, SR, device="cpu")
    assert set(got) == set(want)
    assert got["has_music"] == want["has_music"] and got["reason"] == want["reason"]
    if kind == "short":
        assert got == want
        return
    assert want["has_music"] == (kind == "music")
    assert abs(got["energy_cv"] - want["energy_cv"]) <= 1e-5
    assert abs(got["confidence"] - want["confidence"]) <= 1e-5 / 0.4

    padded, n_valid = pt_bucketing.pad_to_bucket(audio, SR)
    dev = pt_music.analyze_device(torch.from_numpy(padded), n_valid, SR)
    jdev = jax_music.analyze_device(jnp.asarray(padded), n_valid, SR)
    assert dev["has_music"] == jdev["has_music"] == want["has_music"]
    assert abs(dev["energy_cv"] - jdev["energy_cv"]) <= 1e-5
    assert abs(dev["energy_cv"] - want["energy_cv"]) <= 1e-5


def test_window_energies_equal_jax():
    x = np.random.default_rng(3).standard_normal(SR * 3 + 123).astype(np.float32)
    got = pt_music.window_energies(torch.from_numpy(x), SR).numpy()
    want = np.asarray(jax_music.window_energies(jnp.asarray(x), SR))
    assert got.shape == want.shape == (60,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n, target", [(0, 8), (5, 17), (17, 17), (30, 12)])
def test_tile_to_length_equal_jax(n, target):
    clip = np.arange(n, dtype=np.float32)
    got = pt_bucketing.tile_to_length(clip, target)
    want = jax_bucketing.tile_to_length(clip, target)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- REPET ----------------------------------------------------------------------


def _mag(audio):
    from modular_audio_pipeline_tpu.ops.stft import stft

    return np.abs(np.asarray(stft(jnp.asarray(audio), n_fft=2048, hop=512)))


@pytest.mark.parametrize("seconds", [12.0, 30.0])
def test_find_repeating_period_equal_jax(seconds):
    """The beat spectrum and the period, on the JAX package's spectrogram
    and on the port's own."""
    audio = music_mix(seconds)
    power = _mag(audio) ** 2
    np.testing.assert_array_equal(pt_repet.beat_spectrum(power), jax_repet.beat_spectrum(power))
    want = jax_repet.find_repeating_period(power, SR)
    assert pt_repet.find_repeating_period(power, SR) == want
    from modular_audio_pipeline_tpu_torch.ops.stft import stft

    mag = stft(torch.from_numpy(audio), n_fft=2048, hop=512).abs().numpy()
    assert pt_repet.find_repeating_period(mag ** 2, SR) == want


@pytest.mark.parametrize("period", [7, 31, 100])
def test_repeating_mask_equal_jax(period):
    """The median of 12 shifted copies, an even count: the mean of the two
    middle values, as jnp.median takes it (torch.median's lower value
    misses by up to 0.37 on such data)."""
    mag = np.abs(np.random.default_rng(period).standard_normal((65, 300))).astype(np.float32)
    want = np.asarray(jax_repet._repeating_mask(jnp.asarray(mag), jnp.asarray(period, jnp.int32)))
    got = pt_repet._repeating_mask(torch.from_numpy(mag), period).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seconds", [12.0, 40.0])
def test_repet_separate_equal_jax(seconds):
    """Tiled to the bucket, the same period, stems within 1e-5."""
    audio = music_mix(seconds)
    jv, jm = jax_repet.repet_separate(audio, SR)
    pv, pm = pt_repet.repet_separate(audio, SR, device="cpu")
    assert pv.shape == jv.shape == (len(audio),) and pv.dtype == np.float32
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pm, jm, rtol=0, atol=1e-5)
    assert np.abs(jv).max() > 0.05  # the voice is not all removed


# -- MaskUNet -------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    """(JAX MaskUNet, port MaskUNet) on the shipped bundle."""
    from modular_audio_pipeline_tpu.models.whisper.convert import load_params as jax_load

    return JaxMaskUNet(params=jax_load(str(BUNDLE))), MaskUNet(load_params(str(BUNDLE)),
                                                                  device="cpu")


def test_bundle_layout():
    tree = load_params(str(BUNDLE))
    assert tree["down0"]["w"].shape == (32, 2, 3, 3)
    assert tree["up3"]["w"].shape == (256, 512, 3, 3)
    assert tree["head"]["w"].shape == (1, 32, 1, 1)
    assert sum(len(v) for v in tree.values()) == 20
    jax_tree = JaxMaskUNet.init_params(0)
    assert {k: {kk: vv.shape for kk, vv in v.items()} for k, v in jax_tree.items()} == {
        k: {kk: vv.shape for kk, vv in v.items()} for k, v in tree.items()}


@pytest.mark.parametrize("frames", [300, 47, 938])
def test_masknet_apply_equal_jax_on_bundle(nets, frames):
    """The shipped bundle on random magnitudes of several lengths (padded
    to a multiple of 16 inside, cut back after)."""
    jn, pn = nets
    mag = np.abs(np.random.default_rng(frames).standard_normal((1, 1025, frames))) * 3
    mag = mag.astype(np.float32)
    want = np.asarray(JaxMaskUNet.apply(jn.params, jnp.asarray(mag)))
    got = pn(torch.from_numpy(mag)).numpy()
    assert got.shape == want.shape == (1, 1025, frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_masknet_apply_equal_jax_on_random_tree(seed):
    """A random init_params tree of the JAX package carried across: the
    strided "SAME" convolutions and the transposed ones, at every level."""
    tree = JaxMaskUNet.init_params(seed)
    pn = MaskUNet(jax.tree.map(np.asarray, tree), device="cpu")
    mag = np.abs(np.random.default_rng(seed).standard_normal((2, 120, 75))).astype(np.float32)
    want = np.asarray(JaxMaskUNet.apply(tree, jnp.asarray(mag)))
    got = pn(torch.from_numpy(mag)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_masknet_stems_equal_jax_and_device_equals_host(nets):
    """separate (host in, host out) against the JAX package's, and
    separate_device against separate, on a 9 s clip."""
    jn, pn = nets
    mix = music_mix(9.0)
    jv, jm = jn.separate(mix, SR)
    pv, pm = pn.separate(mix, SR)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pm, jm, rtol=0, atol=1e-5)
    dev = pn.separate_device(torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(dev, pv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dev, np.asarray(jn.separate_device(jnp.asarray(mix))),
                               rtol=0, atol=1e-5)


# -- backend resolution and the file-to-file stage -----------------------------------


@pytest.mark.parametrize("root", ["shipped", "empty", "broken"])
def test_backend_resolution_equal_jax(root, tmp_path, monkeypatch):
    """The shipped bundle gives the MaskUNet, no bundle REPET, a bundle that
    fails its probe REPET too, in both packages, with equal stems."""
    from modular_audio_pipeline_tpu import separator as jax_sep
    from modular_audio_pipeline_tpu_torch import separator as pt_sep

    if root != "shipped":
        monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path))
    if root == "broken":  # an older layout: 16 channels wide
        bad = tmp_path / "separation-htdemucs"
        bad.mkdir()
        np.savez(bad / "params.npz", **{"down0/w": np.zeros((16, 2, 3, 3), np.float32),
                                        "down0/b": np.zeros(16, np.float32)})
    net = pt_sep.get_device_separation("htdemucs", device="cpu")
    assert (net is not None) == (jax_sep.get_device_separation("htdemucs") is not None)
    assert (net is not None) == (root == "shipped")
    mix = music_mix(6.0)
    want = jax_sep.get_separation_backend("htdemucs")(mix, SR)
    got = pt_sep.get_separation_backend("htdemucs", device="cpu")(mix, SR)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["masknet", "repet"])
def test_vocal_separator_writes_the_jax_stem(backend, tmp_path, monkeypatch):
    """extract_vocals on a 12 s music file, in 5 s chunks with a checkpoint
    manager: the same stem file as the JAX stage (to one int16 step), the
    partial export, the checkpoint reused on a second call; a speech file
    is passed through untouched by both."""
    from modular_audio_pipeline_tpu.audio_io import read_wav, write_wav
    from modular_audio_pipeline_tpu.separator import VocalSeparator as JaxSeparator
    from modular_audio_pipeline_tpu.utils import CheckpointManager as JaxCheckpoints
    from modular_audio_pipeline_tpu_torch.separator import VocalSeparator
    from modular_audio_pipeline_tpu_torch.utils import CheckpointManager

    if backend == "repet":
        monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path / "none"))
    mix = music_mix(12.0)
    path = str(tmp_path / "mix.wav")
    write_wav(path, mix / np.abs(mix).max() * 0.8, SR)
    jsep = JaxSeparator(SR, str(tmp_path / "jax"), chunk_minutes=5 / 60,
                        checkpoint_manager=JaxCheckpoints(str(tmp_path / "jax_ck")))
    psep = VocalSeparator(SR, str(tmp_path / "pt"), chunk_minutes=5 / 60,
                          checkpoint_manager=CheckpointManager(str(tmp_path / "pt_ck")),
                          device="cpu")
    want_path, got_path = jsep.extract_vocals(path), psep.extract_vocals(path)
    assert got_path != path and want_path != path
    want, _ = read_wav(want_path)
    got, _ = read_wav(got_path)
    assert got.shape == want.shape == (len(mix),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 32768 + 1e-7)
    assert (tmp_path / "pt" / "mix_vocals_partial.wav").exists()
    assert psep.extract_vocals(path) == got_path  # from the checkpoint
    assert (psep._backend_fn is not None) and (
        (backend == "masknet") == hasattr(psep._backend_fn, "__self__"))

    talk = str(tmp_path / "talk.wav")
    write_wav(talk, speech(), SR)
    assert psep.extract_vocals(talk) == jsep.extract_vocals(talk) == talk
    assert not psep.is_separation_needed(talk)


def test_noop_separator():
    from modular_audio_pipeline_tpu_torch.separator import NoOpVocalSeparator

    sep = NoOpVocalSeparator()
    assert sep.extract_vocals("x.wav") == "x.wav" and not sep.is_separation_needed("x.wav")


def _load(path):
    """A script of the repo (not a package module) as a module."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(Path(path).stem, Path(__file__).parent.parent / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voices_equal_jax(seed):
    """The port's copy of the voice model draws the same voices and
    utterances as the JAX package's from the same generator state."""
    from modular_audio_pipeline_tpu.training import voices as jax_voices
    from modular_audio_pipeline_tpu_torch.training import voices as pt_voices

    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for pause_prob in (0.15, 1.0):
        vj, vp = jax_voices.sample_voice(rj), pt_voices.sample_voice(rp)
        assert vars(vj) == vars(vp)
        seconds = float(rj.uniform(0.8, 3.0))
        assert seconds == float(rp.uniform(0.8, 3.0))
        uj = jax_voices.synth_utterance(vj, seconds, rj, pause_prob=pause_prob)
        up = pt_voices.synth_utterance(vp, seconds, rp, pause_prob=pause_prob)
        assert up.dtype == uj.dtype and np.array_equal(up, uj)
    assert rj.random() == rp.random()


def test_smoke_podcast_is_bench_config_4s(monkeypatch):
    """chip_smoke.py's phase-7 audio equals tools/bench_configs.music_podcast
    (the JAX bench's config 4), here over 6 s with its disk cache off."""
    import pathlib

    smoke, bench = _load("chip_smoke.py"), _load("tools/bench_configs.py")
    monkeypatch.setattr(pathlib.Path, "exists", lambda self: False)
    monkeypatch.setattr(np, "save", lambda *args, **kw: None)
    mine, theirs = smoke.music_podcast(6.0), bench.music_podcast(6.0)
    assert mine.dtype == theirs.dtype == np.float32 and np.array_equal(mine, theirs)

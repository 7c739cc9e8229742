"""The serving path's DSP statistics and VAD, port against the JAX package.

The same numpy-seeded signals go through the JAX functions (CPU) and their
port counterparts (``device="cpu"``). Tolerances, and why:

- ``stft``/``istft``, ``k_weight``: 1e-5 of the signal's (or spectrum's)
  peak: f32 FFTs of two libraries.
- ``spectral_gate_stationary``: the binary mask compares f32 dB values
  from two FFT libraries with a threshold, so a bin within float noise of
  it may fall the other way; bins whose margin is under 1e-3 dB are
  counted, every other bin must be equal; the waveform within 1e-4 of peak.
- ``frame_features`` 1e-5 relative; ``band_energies`` 1e-5 relative (bands)
  and 1e-4 dB; the ConvVAD's features 1e-4; its probabilities with the
  shipped bundle 1e-5 (f32 convolutions summed in another order).
- Host decisions (noise segments, the whole-file gain, silence ranges,
  speech timestamps, the hangover machine) are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu import serving as jax_serving
from modular_audio_pipeline_tpu.models import vad_net as jax_vad_net
from modular_audio_pipeline_tpu.ops import loudness as jax_loudness
from modular_audio_pipeline_tpu.ops import noise_detect as jax_noise
from modular_audio_pipeline_tpu.ops import spectral_gate as jax_gate
from modular_audio_pipeline_tpu.ops import stft as jax_stft
from modular_audio_pipeline_tpu.ops import vad_ops as jax_vad_ops
from modular_audio_pipeline_tpu_torch import serving as pt_serving
from modular_audio_pipeline_tpu_torch.models import vad_net as pt_vad_net
from modular_audio_pipeline_tpu_torch.ops import loudness as pt_loudness
from modular_audio_pipeline_tpu_torch.ops import noise_detect as pt_noise
from modular_audio_pipeline_tpu_torch.ops import silence as pt_silence
from modular_audio_pipeline_tpu_torch.ops import spectral_gate as pt_gate
from modular_audio_pipeline_tpu_torch.ops import stft as pt_stft
from modular_audio_pipeline_tpu_torch.ops import vad_ops as pt_vad_ops

SR = 16000


def speechlike(seconds: float, seed: int) -> np.ndarray:
    """Voiced harmonics gated on and off, over a noise floor, with a quiet
    noise-only second at each end (the serving tests' kind of signal)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum((0.3 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / SR) for k in range(1, 5))
    env = (np.sin(2 * np.pi * 1.1 * t) > -0.4).astype(np.float32)
    out = (sig * env * 0.3 + 0.003 * rng.standard_normal(n)).astype(np.float32)
    out[:SR] = 0.0008 * rng.standard_normal(SR)
    out[-SR:] = 0.0008 * rng.standard_normal(SR)
    return out


@pytest.fixture(scope="module")
def signal():
    return speechlike(12.0, 0)


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def test_stft_istft_match_jax(signal):
    want = np.asarray(jax_stft.stft(jnp.asarray(signal), n_fft=1024, hop=256))
    got = pt_stft.stft(t(signal), n_fft=1024, hop=256).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    back_j = np.asarray(jax_stft.istft(jnp.asarray(want), n_fft=1024, hop=256,
                                       length=len(signal)))
    back_p = pt_stft.istft(t(want), n_fft=1024, hop=256, length=len(signal)).numpy()
    peak = np.abs(signal).max()
    np.testing.assert_allclose(back_p, back_j, rtol=0, atol=1e-5 * peak)
    np.testing.assert_allclose(back_p, signal, rtol=0, atol=1e-5 * peak)


@pytest.mark.parametrize("seconds", [3.0, 12.0])
def test_k_weight_matches_jax(seconds):
    x = speechlike(seconds, 1)
    want = np.asarray(jax_loudness.k_weight(jnp.asarray(x), SR))
    got = pt_loudness.k_weight(t(x), SR).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(x).max())


def test_spectral_gate_matches_jax(signal):
    noise = signal[: 2 * SR]
    want = np.asarray(jax_gate.spectral_gate_stationary(jnp.asarray(signal), jnp.asarray(noise), SR))
    got = pt_gate.spectral_gate_stationary(t(signal), t(noise), SR).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(signal).max())

    # the binary mask, each package's own (the JAX function's lines)
    def jax_mask():
        sig_db = jax_gate.amp_to_db(jax_stft.stft(jnp.asarray(signal), n_fft=1024, hop=256))
        noise_db = jax_gate.amp_to_db(jax_stft.stft(jnp.asarray(noise), n_fft=1024, hop=256))
        thresh = noise_db.mean(-1, keepdims=True) + 1.5 * jnp.std(noise_db, -1, keepdims=True)
        return np.asarray(sig_db), np.asarray(thresh)

    def pt_mask():
        sig_db = pt_gate.amp_to_db(pt_stft.stft(t(signal), n_fft=1024, hop=256))
        noise_db = pt_gate.amp_to_db(pt_stft.stft(t(noise), n_fft=1024, hop=256))
        thresh = noise_db.mean(-1, keepdim=True) + 1.5 * noise_db.std(-1, keepdim=True,
                                                                        correction=0)
        return sig_db.numpy(), thresh.numpy()

    (jdb, jth), (pdb, pth) = jax_mask(), pt_mask()
    np.testing.assert_allclose(pth, jth, rtol=0, atol=1e-3)  # ddof 0 on both sides
    near = np.abs(jdb - jth) < 1e-3  # 30 of 385,263 bins on this signal
    assert near.sum() <= 1e-3 * near.size, near.sum()
    np.testing.assert_array_equal((pdb > pth)[~near], (jdb > jth)[~near])


def test_frame_features_match_jax(signal):
    want = np.asarray(jax_noise.frame_features(jnp.asarray(signal), SR))
    got = pt_noise.frame_features(t(signal), SR).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)


def test_noise_segments_equal_on_own_features():
    """Decisions from each package's device features: noise stretches at
    both ends and in the middle."""
    x = speechlike(20.0, 2)
    x[9 * SR : 10 * SR] = 0.0008 * np.random.default_rng(3).standard_normal(SR)
    fj = np.asarray(jax_noise.frame_features(jnp.asarray(x), SR))
    fp = pt_noise.frame_features(t(x), SR).numpy()
    want = jax_noise.noise_segments_from_features(fj[0], fj[1], SR)
    got = pt_noise.noise_segments_from_features(fp[0], fp[1], SR)
    assert want and got == want


@pytest.mark.parametrize("frame_ms", [30, 32])
def test_band_energies_match_jax(signal, frame_ms):
    bj, dj = (np.asarray(a) for a in jax_vad_ops.band_energies(jnp.asarray(signal), SR, frame_ms))
    bp, dp = (a.numpy() for a in pt_vad_ops.band_energies(t(signal), SR, frame_ms))
    assert bp.shape == bj.shape == (len(signal) // (SR * frame_ms // 1000), 6)
    np.testing.assert_allclose(bp, bj, rtol=1e-5, atol=1e-5 * bj.max())
    np.testing.assert_allclose(dp, dj, rtol=0, atol=1e-4)
    assert np.array_equal(pt_vad_ops.flags_from_band_stats(bp, dp, 1),
                          jax_vad_ops.flags_from_band_stats(bj, dj, 1))


@pytest.mark.parametrize("padding_ms, start_th, stop_th", [
    (500, 0.5, 0.9), (300, 0.5, 0.9), (90, 0.75, 0.25), (30, 0.0, 0.0),
])
def test_hangover_segments_equal_jax_scan(padding_ms, start_th, stop_th):
    """The host loop against the JAX package's lax.scan, on flag runs of
    random lengths (and a segment still open at the end)."""
    rng = np.random.default_rng(padding_ms)
    runs = rng.integers(1, 40, size=60)
    flags = np.concatenate([np.full(r, i % 2, np.int32) for i, r in enumerate(runs)])
    flags ^= (rng.random(flags.size) < 0.1).astype(np.int32)  # flicker
    for f in (flags, np.concatenate([flags, np.ones(50, np.int32)]), flags[:0]):
        want = jax_vad_ops.hangover_segments(f, 30, padding_ms, start_th, stop_th)
        assert pt_vad_ops.hangover_segments(f, 30, padding_ms, start_th, stop_th) == want


@pytest.fixture(scope="module")
def conv_vads():
    from modular_audio_pipeline_tpu.vad import load_vad_model as jax_load
    from modular_audio_pipeline_tpu_torch.vad import load_vad_model as pt_load

    (jm, jt), (pm, pt) = jax_load(None, 0.5), pt_load(0.5, device="cpu")
    assert isinstance(pm, pt_vad_net.ConvVAD) and jt == pt == 0.525
    return jm, pm


def test_conv_vad_features_and_probs_match_jax(signal, conv_vads):
    jm, pm = conv_vads
    fj = np.asarray(jax_vad_net.ConvVAD._features(jnp.asarray(signal)))
    fp = pt_vad_net.ConvVAD.features(t(signal)).numpy()
    assert fp.shape == fj.shape == (len(signal) // 512, 16)
    np.testing.assert_allclose(fp, fj, rtol=0, atol=1e-4)
    # the shipped bundle over the same features
    want = np.asarray(jax_vad_net.ConvVAD.forward_from_features(jm.params, jnp.asarray(fj)))
    got = pm(t(fj)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert 0.05 < (want > 0.525).mean() < 0.95  # the bundle tells speech from noise here
    # from each package's own features, with the serving path's gain rescaling
    gain = 3.7
    want = np.asarray(jax_serving._conv_vad_probs_program()(jm.params, jnp.asarray(fj),
                                                             jnp.asarray(gain, jnp.float32)))
    got = pt_serving._conv_vad_probs(pm, t(fp), gain).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    # the decision over each package's own probabilities
    stamps = [jax_vad_net.speech_timestamps_from_probs(want, SR, threshold=0.525),
              pt_vad_net.speech_timestamps_from_probs(got, SR, threshold=0.525)]
    assert stamps[0] and stamps[1] == stamps[0]


def test_energy_speech_probs_equal(signal):
    np.testing.assert_array_equal(pt_vad_net.energy_speech_probs(signal, SR),
                                  jax_vad_net.energy_speech_probs(signal, SR))


@pytest.mark.parametrize("denoise", [False, True], ids=["raw", "denoised"])
def test_dsp_statistics_match_jax(signal, denoise):
    """One section's statistics (the JAX package's fused program against
    the port's function), int16 input converted on the device, 1 s of
    left context; then the host decisions from each package's own."""
    x16 = np.round(np.concatenate([np.zeros(SR), signal]) * 32768).astype(np.int16)
    jax_out = [np.asarray(a) for a in jax_serving._dsp_stats_program(SR, denoise, 0.8, True)(
        jnp.asarray(x16), jnp.asarray(3 * SR, jnp.int32))]
    pt_out = [a.numpy() for a in pt_serving._dsp_stats(t(x16), 3 * SR, SR, denoise, 0.8, True)]
    x_j, peak_j, ks_j, sq_j, bd_j, db_j, vf_j = jax_out
    x_p, peak_p, ks_p, sq_p, bd_p, db_p, vf_p = pt_out
    peak = np.abs(x_j).max()
    wave_tol = 1e-4 if denoise else 0.0
    np.testing.assert_allclose(x_p, x_j, rtol=0, atol=wave_tol * peak)
    np.testing.assert_allclose(peak_p, peak_j, rtol=10 * wave_tol, atol=0)
    np.testing.assert_allclose(ks_p, ks_j, rtol=1e-5, atol=1e-5 * ks_j.max())
    np.testing.assert_allclose(sq_p, sq_j, rtol=1e-5, atol=1e-5 * sq_j.max())
    np.testing.assert_allclose(bd_p, bd_j, rtol=1e-5, atol=1e-5 * bd_j.max())
    np.testing.assert_allclose(db_p, db_j, rtol=0, atol=1e-4)
    # log10 of band energies: where the gate cut a band to near nothing, a
    # 1e-7 relative difference of the waveform is a larger one of the band
    np.testing.assert_allclose(vf_p, vf_j, rtol=0, atol=1e-3 if denoise else 1e-4)

    # host decisions from each package's own statistics
    gains = [jax_serving._whole_file_gain([float(peak_j)], jax_serving._blocks_from_subblocks(ks_j)),
             pt_serving._whole_file_gain([float(peak_p)], pt_serving._blocks_from_subblocks(ks_p))]
    assert gains[1][0] == pytest.approx(gains[0][0], rel=1e-5)
    assert np.isfinite(gains[0][1])
    n_ms = len(signal) // 16
    want = jax_serving._nonsilent_from_block_sums(sq_j * gains[0][0] ** 2, n_ms)
    got = pt_serving._nonsilent_from_block_sums(sq_p * gains[1][0] ** 2, n_ms)
    assert want and got == want


def test_host_decisions_are_copies():
    """On identical inputs the copied host functions give identical
    results: the gain, silence ranges, speech timestamps, noise segments."""
    rng = np.random.default_rng(7)
    subs = np.abs(rng.standard_normal(300)) * 1e-3
    for peaks in ([0.3], [0.3, 0.9], [0.0], [1e-5]):
        assert (pt_serving._whole_file_gain(peaks, pt_serving._blocks_from_subblocks(subs))
                == jax_serving._whole_file_gain(peaks, jax_serving._blocks_from_subblocks(subs)))
    from modular_audio_pipeline_tpu.ops.silence import detect_nonsilent_from_block_sums as jax_ns

    sq = np.abs(rng.standard_normal(5000)) * (rng.random(5000) > 0.3)
    sq[1000:1600] = 0.0
    for n_ms, msl in ((5000, 250), (200, 250), (5000, 100)):
        assert pt_silence.detect_nonsilent_from_block_sums(sq, n_ms, msl) == jax_ns(sq, n_ms, msl)
    probs = np.clip(np.cumsum(rng.standard_normal(600)) * 0.1 + 0.5, 0, 1).astype(np.float32)
    for th in (0.3, 0.525, 0.8):
        assert (pt_vad_net.speech_timestamps_from_probs(probs, SR, threshold=th)
                == jax_vad_net.speech_timestamps_from_probs(probs, SR, threshold=th))
    e, z = rng.random(800).astype(np.float32), rng.random(800).astype(np.float32)
    assert (pt_noise.noise_segments_from_features(e, z, SR)
            == jax_noise.noise_segments_from_features(e, z, SR))
    bands, db = rng.random((400, 6)) * 1e-3, rng.uniform(-80, -10, 400)
    assert np.array_equal(pt_serving._speech_probs_from_bands(bands, db),
                          jax_serving._speech_probs_from_bands(bands, db))

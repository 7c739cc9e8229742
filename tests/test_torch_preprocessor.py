"""The port's AudioPreprocessor and its ops held against the JAX package
on the CPU.

Each stage runs on the same input in both packages: through the device
hand-off (published padded tensors, the path ``AudioPipeline`` takes) and
through the host paths (a file, an explicit noise sample, audio shorter
than the 2 s profile, the ``*_array`` forms). Output lengths, mappings
and decisions are equal; waveforms agree to 1e-5 of their peak (f32
FFTs and sums of two libraries); loudness to 1e-3 LU. The test signals
sit far from the decisions made on a float: every 250 ms silence window
is more than 1e-4 (relative) away from its threshold, and every measured
loudness more than 1 LU from the -70 LUFS skip.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu import audio_io as jio
from modular_audio_pipeline_tpu.ops import dynamics as jdyn
from modular_audio_pipeline_tpu.ops import loudness as jloud
from modular_audio_pipeline_tpu.ops import silence as jsil
from modular_audio_pipeline_tpu.ops import vad_ops as jvad
from modular_audio_pipeline_tpu.preprocessor import AudioPreprocessor as JaxPreprocessor
from modular_audio_pipeline_tpu_torch import audio_io as pio
from modular_audio_pipeline_tpu_torch.ops import dynamics, loudness, silence, vad_ops
from modular_audio_pipeline_tpu_torch.preprocessor import AudioPreprocessor

SR = 16000
WAVE_TOL = 1e-5  # of the peak: f32 FFTs and reductions of two libraries
# of the peak, after a spectral gate whose noise profile was tiled from
# the detected run: a time-frequency bin within 1e-3 dB of its threshold
# may fall the other way (ROADMAP.md §C; one bin on speech(), as in
# tests/test_torch_dsp.py, which holds the gate to the same 1e-4)
GATE_TOL = 1e-4
LUFS_TOL = 1e-3


def speech(seconds=12.0, seed=0, noise_mid=True):
    """Harmonic 'speech' in bursts with silent gaps, a hiss stretch in the
    middle (the noise profile's auto-detection finds it) and hiss at the
    edges."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum((0.3 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / SR) for k in range(1, 5))
    env = (np.sin(2 * np.pi * 0.45 * t) > -0.2).astype(np.float64)
    out = sig * env * 0.3 + 0.0005 * rng.standard_normal(n)
    if noise_mid:
        mid = slice(n // 2 - SR // 2, n // 2 + SR // 2)
        out[mid] = 0.004 * rng.standard_normal(SR)
    return out.astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def close(got, want, tol=WAVE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def astuples(mappings):
    return [dataclasses.astuple(m) for m in mappings]


def silence_margin(x, min_silence_len=250, offset_db=40.0):
    """Smallest |window mean square / threshold - 1| over the 250 ms windows."""
    spms = SR // 1000
    n_ms = len(x) // spms
    blocks = np.square(x[: n_ms * spms].astype(np.float64)).reshape(n_ms, spms).sum(-1)
    cs = np.concatenate([[0.0], np.cumsum(blocks)])
    thresh = cs[-1] / (n_ms * spms) * 10 ** (-offset_db / 10)
    win = (cs[min_silence_len:] - cs[:-min_silence_len]) / (min_silence_len * spms)
    return float(np.min(np.abs(win / thresh - 1.0)))


def pair(tmp_path, **kw):
    return (JaxPreprocessor(SR, str(tmp_path / "jax"), **kw),
            AudioPreprocessor(SR, str(tmp_path / "pt"), device="cpu", **kw))


def run_chain(pre, io, wav):
    """denoise -> normalize -> loudness -> silence through published buffers;
    each stage's output as a host array, and the mappings."""
    paths = [pre.reduce_stationary_noise(wav)]
    paths.append(pre.normalize_audio(paths[-1]))
    paths.append(pre.normalize_loudness(paths[-1]))
    out, mappings = pre.remove_silence(paths[-1])
    paths.append(out)
    bufs = [io.get_buffer(p) for p in paths]
    return paths, [b.as_host() for b in bufs], mappings, bufs


@pytest.mark.parametrize("noise_mid", [True, False], ids=["noise-found", "no-noise-run"])
def test_stage_chain_through_device_buffers_equals_jax(tmp_path, noise_mid):
    audio = speech(noise_mid=noise_mid)
    wav = str(tmp_path / "rec.wav")
    jio.write_wav(wav, audio, SR)
    jp, pp = pair(tmp_path)
    j_paths, j_out, j_map, j_bufs = run_chain(jp, jio, wav)
    p_paths, p_out, p_map, p_bufs = run_chain(pp, pio, wav)
    assert [p.rsplit("/", 1)[1] for p in p_paths] == [p.rsplit("/", 1)[1] for p in j_paths]
    assert all(b.tensor is not None for b in p_bufs)  # the device hand-off ran
    for got, want in zip(p_out, j_out):
        close(got, want)
    assert astuples(p_map) == astuples(j_map) and len(p_map) > 1
    assert silence_margin(j_out[2]) > 1e-4
    lufs = float(jloud.integrated_loudness(jnp.asarray(j_out[1]), SR))
    assert abs(lufs + 70.0) > 1.0
    assert abs(float(loudness.integrated_loudness(t(p_out[1]), SR)) - lufs) < LUFS_TOL
    # the WAV checkpoints of the hand-off are written and equal the buffers
    pio.flush_writes()
    for path, host in zip(p_paths, p_out):
        disk, _ = pio.read_wav(path)
        np.testing.assert_allclose(disk, host, rtol=0, atol=1.0 / 32768)


def test_host_paths_equal_jax(tmp_path):
    """remove_silence of a file (the host cut with crossfades), denoise
    with an explicit noise sample (tiled), denoise of audio shorter than
    the 2 s profile."""
    audio = speech()
    wav, noise, short = (str(tmp_path / n) for n in ("rec.wav", "noise.wav", "short.wav"))
    jio.write_wav(wav, audio, SR)
    jio.write_wav(noise, 0.004 * np.random.default_rng(3).standard_normal(SR // 2), SR)
    jio.write_wav(short, audio[: int(1.5 * SR)], SR)
    jp, pp = pair(tmp_path)

    j_out, j_map = jp.remove_silence(wav)
    p_out, p_map = pp.remove_silence(wav)
    assert pio.get_buffer(p_out).tensor is None  # the host path ran
    assert astuples(p_map) == astuples(j_map) and len(p_map) > 1
    close(pio.get_buffer(p_out).as_host(), jio.get_buffer(j_out).as_host())
    assert silence_margin(audio) > 1e-4

    for src, kw in ((wav, {"noise_sample_path": noise}), (short, {})):
        j = jio.get_buffer(jp.reduce_stationary_noise(src, **kw)).as_host()
        p = pio.get_buffer(pp.reduce_stationary_noise(src, **kw)).as_host()
        close(p, j)


def test_array_forms_equal_jax(tmp_path):
    audio = speech()
    jp, pp = pair(tmp_path)
    close(pp.reduce_stationary_noise_array(audio, SR), jp.reduce_stationary_noise_array(audio, SR),
          GATE_TOL)
    clip = audio[: SR // 2]
    close(pp.reduce_stationary_noise_array(audio, SR, clip),
          jp.reduce_stationary_noise_array(audio, SR, clip))
    x22 = audio[: 5 * 22050]  # taken as 22.05 kHz audio: resampled first
    (pg, psr), (jg, jsr) = pp.normalize_audio_array(x22, 22050), jp.normalize_audio_array(x22, 22050)
    assert psr == jsr == SR
    close(pg, jg)
    (pl, pc), (jl, jc) = pp.normalize_loudness_array(audio, SR), jp.normalize_loudness_array(audio, SR)
    assert pc == jc is True
    close(pl, jl)
    for denoise in (True, False):
        (pa, pm), (ja, jm) = (pp.preprocess_chain_array(audio, SR, denoise=denoise),
                              jp.preprocess_chain_array(audio, SR, denoise=denoise))
        close(pa, ja)
        assert abs(pm["lufs"] - jm["lufs"]) < LUFS_TOL and abs(jm["lufs"] + 70) > 1
    wav = str(tmp_path / "rec.wav")
    jio.write_wav(wav, audio, SR)
    assert pp.detect_silence_segments(wav) == jp.detect_silence_segments(wav)


def test_quiet_audio_skips_loudness_as_jax(tmp_path):
    """Audio near -90 LUFS (20 LU below the skip) passes through."""
    quiet = (3e-5 * np.sin(2 * np.pi * 440 * np.arange(3 * SR) / SR)).astype(np.float32)
    assert float(jloud.integrated_loudness(jnp.asarray(quiet), SR)) < -85
    wav = str(tmp_path / "quiet.wav")
    jio.write_wav(wav, quiet, SR)
    jp, pp = pair(tmp_path)
    assert pp.normalize_loudness(wav) == jp.normalize_loudness(wav) == wav
    assert pp.normalize_loudness_array(quiet, SR)[1] is jp.normalize_loudness_array(quiet, SR)[1] is False


SIGNALS = {
    "speech": lambda: speech(4.0),
    "silence": lambda: np.zeros(SR, np.float32),
    "short": lambda: speech(0.3, noise_mid=False),  # under one 400 ms gating block
    "hot": lambda: np.clip(4.0 * speech(3.0, seed=1), -1, 1),
}


@pytest.mark.parametrize("name", SIGNALS)
def test_dynamics_and_loudness_equal_jax(name):
    x = SIGNALS[name]()
    jx = jnp.asarray(x)
    for got, want in ((dynamics.dbfs(t(x)), jdyn.dbfs(jx)),
                      (dynamics.peak_dbfs(t(x)), jdyn.peak_dbfs(jx)),
                      (loudness.integrated_loudness(t(x), SR), jloud.integrated_loudness(jx, SR))):
        got, want = float(got), float(want)
        assert (got == want == -np.inf) or abs(got - want) < LUFS_TOL
    close(dynamics.peak_normalize(t(x)).numpy(), np.asarray(jdyn.peak_normalize(jx)))
    out, lufs = loudness.measure_and_normalize(t(x), SR, -16.0)
    j_out, j_lufs = jloud.measure_and_normalize(jx, SR, -16.0)
    assert np.isfinite(float(lufs)) == np.isfinite(float(j_lufs))
    close(out.numpy(), np.asarray(j_out))
    close(loudness.normalize_loudness(t(x), -30.0, -16.0).numpy(),
          np.asarray(jloud.normalize_loudness(jx, -30.0, -16.0)))


def test_silence_ops_equal_jax():
    """Block sums and the device gather against JAX; the host cut (native
    crossfades) against the NumPy fallback's and JAX's."""
    from modular_audio_pipeline_tpu_torch.ops.bucketing import pad_to_bucket

    x = speech(9.0)
    padded, n = pad_to_bucket(x, SR)
    spms = SR // 1000
    blocks = silence.block_sums_device(t(padded), spms).numpy()
    np.testing.assert_allclose(blocks, np.asarray(jsil.block_sums_device(jnp.asarray(padded), spms)),
                               rtol=1e-5, atol=1e-12)
    ranges = silence.detect_nonsilent_from_block_sums(blocks, n // spms)
    assert ranges == jsil.detect_nonsilent_from_block_sums(blocks, n // spms) and len(ranges) > 1
    plan = silence.build_cut_plan(ranges, n // spms, spms)
    j_plan = jsil.build_cut_plan(ranges, n // spms, spms)
    for a, b in zip(plan[:4], j_plan[:4]):
        np.testing.assert_array_equal(a, b)
    assert astuples(plan[4]) == astuples(j_plan[4]) and plan[5] == j_plan[5]
    out, n_out = silence.gather_cut_device(t(padded), SR, *plan[:4], plan[5])
    j_out, j_n = jsil.gather_cut_device(jnp.asarray(padded), SR, *j_plan[:4], j_plan[5])
    assert n_out == j_n and out.shape[0] == j_out.shape[0]
    close(out.numpy(), np.asarray(j_out), 1e-6)

    host, mappings, changed = silence.remove_silence(x, SR)
    j_host, j_mappings, j_changed = jsil.remove_silence(x, SR)
    assert changed and j_changed and astuples(mappings) == astuples(j_mappings)
    close(host, j_host, 1e-6)
    np.testing.assert_allclose(host[: n_out], out.numpy()[:n_out], rtol=0, atol=1e-6)
    chunks = [x[:4000], x[5000:9000], x[12000:20000]]
    native = silence._crossfade_concat(chunks, [20, 5], SR)
    from modular_audio_pipeline_tpu_torch.runtime import native_lib

    saved = native_lib.native_crossfade_concat
    native_lib.native_crossfade_concat = lambda *a: None
    try:
        fallback = silence._crossfade_concat(chunks, [20, 5], SR)
    finally:
        native_lib.native_crossfade_concat = saved
    close(native, fallback, 1e-6)
    assert silence.detect_silence_ranges(x, SR) == jsil.detect_silence_ranges(x, SR)
    assert silence.detect_nonsilent_ranges(x, SR) == jsil.detect_nonsilent_ranges(x, SR)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_frame_speech_flags_equal_jax(mode):
    x = speech(8.0)
    got = vad_ops.frame_speech_flags(x, SR, 30, mode, device="cpu")
    want = jvad.frame_speech_flags(x, SR, 30, mode)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("shape", [(300_000,), (3, 70_001)])
def test_biquad_and_sosfilt_equal_jax(shape):
    """The doubling scan against the JAX package's associative scan and
    scipy's serial filter (float64): both scans associate the sums in
    other orders than a serial filter, so 1e-5 of the output's peak."""
    import scipy.signal

    from modular_audio_pipeline_tpu.ops import iir as jiir
    from modular_audio_pipeline_tpu_torch.ops import iir

    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    b, a = np.array([0.2, 0.1, -0.05]), np.array([1.0, -0.6, 0.08])
    got = iir.biquad_filter(t(x), b, a).numpy()
    close(got, np.asarray(jiir.biquad_filter(jnp.asarray(x), b, a)))
    close(got, scipy.signal.lfilter(b, a, x.astype(np.float64), axis=-1))
    sos = scipy.signal.butter(4, 0.1, output="sos")
    got = iir.sosfilt(t(x), sos).numpy()
    close(got, np.asarray(jiir.sosfilt(jnp.asarray(x), sos)))
    close(got, scipy.signal.sosfilt(sos, x.astype(np.float64), axis=-1))

"""The port's VAD stages held against the JAX package's on the CPU:
``VADFilter`` (frame classifier + hangover machine), ``SileroVADFilter``
with the shipped ConvVAD bundle (the device cut of a published tensor,
the host cut of a file, and the device cut handing back to the host cut
when a boundary is off the 1 ms grid), with energy probabilities (no
bundle) and with a converted Silero bundle of random weights, and
``NoOpVADFilter``. Keep intervals, mappings and output lengths are equal;
the kept audio agrees to 1e-6 (the cut copies samples; the device gather
multiplies them by 1.0)."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from test_torch_preprocessor import speech
from test_torch_silero import silero_root  # noqa: F401  (fixture)

from modular_audio_pipeline_tpu import audio_io as jio
from modular_audio_pipeline_tpu import vad as jvad
from modular_audio_pipeline_tpu.ops.bucketing import pad_to_bucket
from modular_audio_pipeline_tpu_torch import audio_io as pio
from modular_audio_pipeline_tpu_torch import vad as pvad

SR = 16000


def astuples(mappings):
    return [dataclasses.astuple(m) for m in mappings]


def publish(tmp_path, audio):
    """The same audio published as a padded device buffer in both packages."""
    import jax.numpy as jnp

    path = str(tmp_path / "in.wav")
    padded, n = pad_to_bucket(audio, SR)
    jio.publish_buffer(path, jio.AudioBuffer(sr=SR, n_valid=n, device=jnp.asarray(padded)))
    pio.publish_buffer(path, pio.AudioBuffer(sr=SR, n_valid=n,
                                             tensor=torch.from_numpy(padded.copy())))
    return path


def run_pair(jf, pf, path, tmp_path):
    (jout, jmap), (pout, pmap) = (jf.filter_voice(path, str(tmp_path / "jax")),
                                  pf.filter_voice(path, str(tmp_path / "pt")))
    assert astuples(pmap) == astuples(jmap)
    if pout == path:  # nothing voiced: both return their input
        assert jout == path and pmap == []
        return pmap, None
    got, want = pio.get_buffer(pout).as_host(), jio.get_buffer(jout).as_host()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    return pmap, got


@pytest.fixture
def dirs(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "pt").mkdir()
    return tmp_path


@pytest.mark.parametrize("mode", [0, 3])
def test_webrtc_filter_equals_jax(dirs, mode):
    audio = speech(10.0)
    wav = str(dirs / "rec.wav")
    jio.write_wav(wav, audio, SR)
    jf = jvad.VADFilter(SR, vad_mode=mode, padding_duration_ms=300)
    pf = pvad.VADFilter(SR, vad_mode=mode, padding_duration_ms=300, device="cpu")
    mappings, kept = run_pair(jf, pf, wav, dirs)
    assert mappings and len(kept) < len(audio)
    assert pf.detect_speech_segments(wav) == jf.detect_speech_segments(wav)


def test_silero_filter_device_and_host_cuts_equal_jax(dirs):
    """The shipped ConvVAD: a published tensor is cut on the device, a file
    on the host; each equals the JAX package's same cut."""
    audio = speech(14.0)
    jf, pf = jvad.SileroVADFilter(), pvad.SileroVADFilter(device="cpu")
    device_map, device_kept = run_pair(jf, pf, publish(dirs, audio), dirs)
    assert pf.last_cut == "device" and type(pf.model).__name__ == "ConvVAD"
    assert device_map and len(device_kept) < len(audio)
    wav = str(dirs / "rec.wav")
    jio.write_wav(wav, audio, SR)
    host_map, _ = run_pair(jf, pf, wav, dirs)
    assert pf.last_cut == "host" and host_map
    assert pf.detect_speech_segments(wav) == jf.detect_speech_segments(wav)


def talk(seconds, seed):
    """Two synthetic voices of the voice model taking turns, with pauses
    (the speech the shipped ConvVAD was trained on)."""
    from modular_audio_pipeline_tpu_torch.training.voices import sample_voice, synth_utterance

    rng = np.random.default_rng(seed)
    voices = [sample_voice(rng) for _ in range(2)]
    out = np.zeros(int(seconds * SR), np.float32)
    pos = 0
    while pos < len(out):
        utt = synth_utterance(voices[rng.integers(2)], float(rng.uniform(2.0, 4.0)), rng,
                              pause_prob=0.15)
        k = min(len(utt), len(out) - pos)
        out[pos : pos + k] = utt[:k]
        pos += k + int(rng.uniform(0.3, 0.8) * SR)
    return out


def test_silero_device_cut_hands_back_off_the_ms_grid(dirs):
    """Audio cut inside its last voiced stretch, 7 samples past a whole
    millisecond: the last keep interval ends with the audio, off the 1 ms
    grid, so both packages hand the device cut back to the host cut."""
    audio = talk(12.0, 0)
    last = pvad.SileroVADFilter(device="cpu")._timestamps(audio, SR)[-1]
    cut = int(last["start"] * SR) + int(0.6 * (last["end"] - last["start"]) * SR) // 16 * 16 + 7
    audio = audio[:cut]
    pf = pvad.SileroVADFilter(device="cpu")
    mappings, _ = run_pair(jvad.SileroVADFilter(), pf, publish(dirs, audio), dirs)
    assert pf.last_cut == "host" and mappings
    assert round(mappings[-1].original_end * SR) == cut


def test_silero_filter_energy_probabilities_equal_jax(dirs, monkeypatch):
    """Without a bundle (an empty weights root) both fall back to the
    energy probabilities and cut on the host, even a published tensor."""
    monkeypatch.setenv("MAP_TPU_WEIGHTS", str(dirs / "empty"))
    audio = speech(12.0)
    pf = pvad.SileroVADFilter(device="cpu")
    mappings, _ = run_pair(jvad.SileroVADFilter(), pf, publish(dirs, audio), dirs)
    assert pf._use_energy and pf.last_cut == "host" and mappings


def test_silero_filter_converted_bundle_equals_jax(dirs, silero_root):  # noqa: F811
    """A converted Silero bundle (random weights of the v5 layout)."""
    audio = speech(12.0)
    pf = pvad.SileroVADFilter(device="cpu")
    run_pair(jvad.SileroVADFilter(), pf, publish(dirs, audio), dirs)
    assert type(pf.model).__name__ == "SileroVAD" and pf.last_cut == "host"


def test_noop_filter_equals_jax(dirs):
    wav = str(dirs / "rec.wav")
    jio.write_wav(wav, speech(3.0), SR)
    got, want = pvad.NoOpVADFilter().filter_voice(wav, str(dirs)), jvad.NoOpVADFilter().filter_voice(wav, str(dirs))
    assert got[0] == want[0] == wav and astuples(got[1]) == astuples(want[1])
    assert pvad.NoOpVADFilter().detect_speech_segments(wav) == jvad.NoOpVADFilter().detect_speech_segments(wav)

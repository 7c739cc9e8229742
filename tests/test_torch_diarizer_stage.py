"""The port's diarization stage (``SpeakerDiarizer.diarize``) held against
the JAX package's on the CPU: the host path (a file, or a published host
buffer: regions from the segmentation model or the energy classifier,
subsegments cut on the host, the embedder over uploaded batches) and the
device path (a published padded tensor), with the shipped bundles and
without them (the StatsEmbedder and energy regions); ``NoOpDiarizer``;
``diarize_with_embedding``'s voiceprints (to 1e-5: f32 embeddings of two
libraries) and ``identify_speakers``. Turns are equal."""

import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from test_torch_vad_filters import talk

from modular_audio_pipeline_tpu import audio_io as jio
from modular_audio_pipeline_tpu import diarizer as jdiar
from modular_audio_pipeline_tpu.ops.bucketing import pad_to_bucket
from modular_audio_pipeline_tpu_torch import audio_io as pio
from modular_audio_pipeline_tpu_torch import diarizer as pdiar

SR = 16000


def turns(segments):
    return [(s.speaker, s.start, s.end, s.track) for s in segments]


@pytest.fixture(scope="module")
def audio():
    return talk(24.0, 3)


@pytest.mark.parametrize("bundles", [True, False], ids=["shipped-bundles", "no-bundle"])
@pytest.mark.parametrize("source", ["file", "host-buffer", "device-buffer"])
def test_diarize_equals_jax(tmp_path, monkeypatch, audio, bundles, source):
    if not bundles:
        monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path / "empty"))
    path = str(tmp_path / "voiced.wav")
    if source == "file":
        jio.write_wav(path, audio, SR)
    elif source == "host-buffer":
        jio.publish_buffer(path, jio.AudioBuffer(sr=SR, n_valid=len(audio), host=audio))
        pio.publish_buffer(path, pio.AudioBuffer(sr=SR, n_valid=len(audio), host=audio))
    elif source == "device-buffer":
        import jax.numpy as jnp

        padded, n = pad_to_bucket(audio, SR)
        jio.publish_buffer(path, jio.AudioBuffer(sr=SR, n_valid=n, device=jnp.asarray(padded)))
        pio.publish_buffer(path, pio.AudioBuffer(sr=SR, n_valid=n,
                                                 tensor=torch.from_numpy(padded.copy())))
    jd, pd = jdiar.SpeakerDiarizer(), pdiar.SpeakerDiarizer(device="cpu")
    want, j_prints = jd.diarize_with_embedding(path, 1, 5)
    got, p_prints = pd.diarize_with_embedding(path, 1, 5)
    assert turns(got) == turns(want) and len(got) > 1, (turns(got), turns(want))
    assert (pd._segmentation is not None) == bundles
    assert type(pd._embedder).__name__ == ("ConvEmbedder" if bundles else "StatsEmbedder")
    assert p_prints.keys() == j_prints.keys()
    for k in j_prints:
        np.testing.assert_allclose(p_prints[k], j_prints[k], rtol=0, atol=1e-5)
    assert turns(pd.diarize(path, 1, 5)) == turns(want)


def test_identify_speakers_and_noop(tmp_path):
    rng = np.random.default_rng(0)
    prints = {f"SPEAKER_0{i}": rng.standard_normal(8) for i in range(3)}
    refs = {"ann": prints["SPEAKER_01"] + 0.05 * rng.standard_normal(8),
            "bob": prints["SPEAKER_02"] * 2.0, "cy": -prints["SPEAKER_00"]}
    got = pdiar.identify_speakers(prints, refs)
    assert got == jdiar.identify_speakers(prints, refs) == {"SPEAKER_01": "ann",
                                                            "SPEAKER_02": "bob"}
    assert pdiar.identify_speakers(prints, refs, threshold=-1.0) == jdiar.identify_speakers(
        prints, refs, threshold=-1.0)
    path = str(tmp_path / "x.wav")
    jio.write_wav(path, np.zeros(3 * SR, np.float32), SR)
    assert turns(pdiar.NoOpDiarizer().diarize(path)) == turns(jdiar.NoOpDiarizer().diarize(path))

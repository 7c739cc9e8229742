"""The weight-free StatsEmbedder of the port held against the JAX package
on the CPU, alone and inside ``diarize_device_timeline`` when no embedding
bundle exists.

Tolerances: embeddings 1e-5 (unit vectors of f32 statistics); MFCC frames
1e-5 relative to the largest coefficient; ``embed_spans`` is host numpy
copied: 1e-6 over the same frames, 1e-5 over each package's own. Turns and
speaker labels are equal; voiceprints agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diarization import voices
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu import diarizer as jax_diarizer
from modular_audio_pipeline_tpu.models.diarization.embedding import StatsEmbedder as JaxStats
from modular_audio_pipeline_tpu_torch import diarizer as pt_diarizer
from modular_audio_pipeline_tpu_torch.models.diarization.embedding import StatsEmbedder
from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

SR = 16000


@pytest.fixture(scope="module")
def embedders():
    return JaxStats(), StatsEmbedder(device="cpu")


@pytest.mark.parametrize("source", ["voices", "noise"])
def test_embed_equal_jax(embedders, source):
    je, pe = embedders
    if source == "voices":
        x = voices(12.0, 1)[: 8 * 24000].reshape(8, 24000)
    else:
        x = (0.1 * np.random.default_rng(2).standard_normal((5, 24000))).astype(np.float32)
    want = je.embed(x)
    got = pe.embed(x)
    assert got.shape == want.shape == (len(x), 76)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(pe.embed(torch.from_numpy(x)), got, rtol=0, atol=0)


def test_frame_features_equal_jax(embedders):
    je, pe = embedders
    x = voices(7.3, 2)
    want = je.frame_features(x, SR)
    got = pe.frame_features(x, SR)
    assert got.shape == want.shape == ((len(x) - 400) // 160 + 1, 19)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_embed_spans_equal_jax(embedders):
    """Spans inside, across the ends of and beyond the frame grid, one
    frame long and empty."""
    je, pe = embedders
    x = voices(10.0, 3)
    frames = je.frame_features(x, SR)
    spans = np.array([[0, 24000], [12000, 36000], [150000, 174000], [159000, 170000],
                      [0, 160], [800, 800], [24000, 24160]], dtype=np.int64)
    want = je.embed_spans(frames, spans, SR)
    np.testing.assert_allclose(pe.embed_spans(frames, spans, SR), want, rtol=0, atol=1e-6)
    # over the port's own frames: the subsegment-long spans to 1e-5 (the
    # spans of one frame or none take the square root of a cancellation)
    got = pe.embed_spans(pe.frame_features(x, SR), spans[:4], SR)
    np.testing.assert_allclose(got, want[:4], rtol=0, atol=1e-5)


@pytest.mark.parametrize("root, min_spk", [("segmentation", 1), ("segmentation", 2),
                                           ("empty", 2)])
def test_diarize_device_timeline_without_embedding_bundle_equals_jax(root, min_spk, tmp_path,
                                                                    monkeypatch):
    """No ``diarization-embedding`` bundle: the StatsEmbedder in both
    packages, behind the segmentation model (a weights root holding only
    its bundle) or behind the energy regions (an empty root); the same
    turns over a 30 s two-voice timeline padded with zeros."""
    if root == "segmentation":
        (tmp_path / "diarization-segmentation").symlink_to(
            SHIPPED_WEIGHTS / "diarization-segmentation")
    monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path))
    x = np.zeros(40 * SR, np.float32)
    x[: 30 * SR] = voices(30.0, 3)
    jd = jax_diarizer.SpeakerDiarizer()
    pd = pt_diarizer.SpeakerDiarizer(device="cpu")
    want, jprints = jd.diarize_device_timeline(jnp.asarray(x), 30 * SR, SR, min_spk, 5)
    got, pprints = pd.diarize_device_timeline(torch.from_numpy(x), 30 * SR, SR, min_spk, 5)
    assert isinstance(pd._embedder, StatsEmbedder) and not pd._use_noop
    assert (pd._segmentation is not None) == (root == "segmentation")
    assert want
    key = lambda segs: [(s.speaker, s.start, s.end, s.track) for s in segs]  # noqa: E731
    assert key(got) == key(want)
    assert sorted(pprints) == sorted(jprints)
    for k in jprints:
        np.testing.assert_allclose(pprints[k], jprints[k], rtol=0, atol=1e-5)

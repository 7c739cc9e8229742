"""The trained diarization stack, port against the JAX package.

The shipped ``diarization-segmentation`` and ``diarization-embedding``
bundles and numpy-seeded signals go through both packages on the CPU (the
JAX ``flash_attention`` off the TPU is ``attention_reference``, as the
port's is on a CPU tensor). Tolerances, and why:

- ``mfcc_batch``: 1e-4 relative to the largest coefficient (f32 FFT, mel
  and DCT products of two libraries).
- ``SegmentationNet``: logits 1e-4; the marginals, which both packages
  round to f16, equal or one f16 ulp apart.
- ``ConvEmbedder``: 1e-5 (f32 convolutions summed in another order).
- Host decisions (cluster labels, subsegments, turns) are equal; so are
  the turns of ``diarize_device_timeline`` on a two-voice signal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu import diarizer as jax_diarizer
from modular_audio_pipeline_tpu.models.diarization import clustering as jax_clustering
from modular_audio_pipeline_tpu.models.diarization import features as jax_features
from modular_audio_pipeline_tpu.models.diarization import segmentation as jax_seg
from modular_audio_pipeline_tpu.models.diarization.embedding import ConvEmbedder as JaxEmbedder
from modular_audio_pipeline_tpu.models.whisper.convert import load_params
from modular_audio_pipeline_tpu_torch import diarizer as pt_diarizer
from modular_audio_pipeline_tpu_torch.models.diarization import clustering as pt_clustering
from modular_audio_pipeline_tpu_torch.models.diarization import features as pt_features
from modular_audio_pipeline_tpu_torch.models.diarization import segmentation as pt_seg
from modular_audio_pipeline_tpu_torch.models.diarization.embedding import ConvEmbedder
from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

SR = 16000


def voices(seconds: float, seed: int) -> np.ndarray:
    """Two synthetic voices (different pitch and timbre) taking turns every
    4 s, with short pauses and a noise floor."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    out = np.zeros(n)
    for i, (f, tilt) in enumerate([(110.0, 0.6), (230.0, 0.25)]):
        f0 = f + 12 * np.sin(2 * np.pi * 0.5 * t + i)
        sig = sum((tilt ** k) * np.sin(2 * np.pi * (k + 1) * np.cumsum(f0) / SR)
                  for k in range(6))
        turn = ((t // 4) % 2 == i) & ((t % 4) < 3.4)
        out += 0.3 * sig * turn * (0.6 + 0.4 * (np.sin(2 * np.pi * 3 * t) > -0.5))
    return (out + 0.002 * rng.standard_normal(n)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture(scope="module")
def seg_params():
    return load_params(str(SHIPPED_WEIGHTS / "diarization-segmentation"))


@pytest.fixture(scope="module")
def emb_params():
    from modular_audio_pipeline_tpu.models.whisper.convert import unflatten_tree

    with np.load(SHIPPED_WEIGHTS / "diarization-embedding" / "params.npz") as z:
        return unflatten_tree({k: z[k] for k in z.files})


@pytest.mark.parametrize("n_mfcc, n_mels", [(20, 40), (40, 40)])
def test_mfcc_batch_matches_jax(n_mfcc, n_mels):
    x = voices(3.0, 0).reshape(2, -1)
    want = np.asarray(jax_features.mfcc_batch(jnp.asarray(x), sr=SR, n_mfcc=n_mfcc,
                                              n_mels=n_mels))
    got = pt_features.mfcc_batch(t(x), sr=SR, n_mfcc=n_mfcc, n_mels=n_mels).numpy()
    assert got.shape == want.shape == (2, 148, n_mfcc)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_segmentation_net_matches_jax(seg_params):
    """Logits of the shipped bundle (the tanh GELU: the exact one misses
    1e-4 here) and the f16 marginals over 10 s MFCC windows."""
    x = voices(20.0, 1)
    mel = np.asarray(jax_features.mfcc_batch(jnp.asarray(x.reshape(2, -1)), sr=SR,
                                             n_mfcc=40, n_mels=40))
    jnet = jax_seg.SegmentationNet(params=seg_params)
    pnet = pt_seg.SegmentationNet(seg_params, device="cpu")
    want = np.asarray(jnet._apply(jnet.params, jnp.asarray(mel)))
    got = pnet(t(mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    mj = np.asarray(jnet._marginals(jnet.params, jnp.asarray(mel)))
    mp = pnet.marginals(t(mel))
    assert mp.dtype == torch.float16 and mj.dtype == np.float16
    ulps = np.abs(mp.numpy().view(np.int16).astype(np.int32) - mj.view(np.int16).astype(np.int32))
    assert ulps.max() <= 1, ulps.max()
    assert (mj.astype(np.float32).max(-1) > 0.5).any()  # some speech in the windows


def test_conv_embedder_matches_jax(emb_params):
    x = voices(12.0, 2)[: 8 * 24000].reshape(8, 24000)
    want = np.asarray(JaxEmbedder(params=emb_params).embed(x))
    got = ConvEmbedder(emb_params, device="cpu").embed(t(x))
    assert got.shape == want.shape == (8, 192)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("min_spk, max_spk", [(1, 5), (2, 2), (3, 5), (1, 1)])
def test_cluster_labels_equal(min_spk, max_spk):
    rng = np.random.default_rng(min_spk * 10 + max_spk)
    centres = rng.standard_normal((3, 192))
    emb = np.concatenate([c + 0.4 * rng.standard_normal((20, 192)) for c in centres])
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    for kw in ({}, {"threshold": 1.0, "single_cutoff": 0.4}):
        want = jax_clustering.cluster_embeddings(emb, min_spk, max_spk, **kw)
        assert np.array_equal(pt_clustering.cluster_embeddings(emb, min_spk, max_spk, **kw), want)


def test_region_and_turn_helpers_equal():
    rng = np.random.default_rng(5)
    regions = [(0, 40000), (48000, 50000), (60000, 61000), (70000, 200000)]
    pd, jd = pt_diarizer.SpeakerDiarizer, jax_diarizer.SpeakerDiarizer
    spans = pd._subsegments_from_regions(regions, SR)
    assert spans == jd._subsegments_from_regions(regions, SR)
    labels = rng.integers(0, 3, len(spans))
    got = [(s.speaker, s.start, s.end, s.track) for s in pd._turns_from_labels(spans, labels, SR)]
    want = [(s.speaker, s.start, s.end, s.track) for s in jd._turns_from_labels(spans, labels, SR)]
    assert got == want
    flags = rng.random(3000) < 0.6
    assert np.array_equal(pd._smooth_speech_flags(flags), jd._smooth_speech_flags(flags))


@pytest.mark.parametrize("min_spk", [1, 2])
def test_diarize_device_timeline_turns_equal_jax(min_spk):
    """Segmentation regions, device-gathered subsegments, embeddings and
    calibrated AHC over a 30 s two-voice timeline padded with zeros, as
    the serving path hands it over."""
    x = np.zeros(40 * SR, np.float32)
    x[: 30 * SR] = voices(30.0, 3)
    jd = jax_diarizer.SpeakerDiarizer()
    pd = pt_diarizer.SpeakerDiarizer(device="cpu")
    want, jprints = jd.diarize_device_timeline(jnp.asarray(x), 30 * SR, SR, min_spk, 5)
    got, pprints = pd.diarize_device_timeline(t(x), 30 * SR, SR, min_spk, 5)
    assert pd._segmentation is not None and not pd._use_noop
    assert want
    key = lambda segs: [(s.speaker, s.start, s.end, s.track) for s in segs]  # noqa: E731
    assert key(got) == key(want)
    assert sorted(pprints) == sorted(jprints)
    for k in jprints:
        np.testing.assert_allclose(pprints[k], jprints[k], rtol=0, atol=1e-5)


def test_unported_embedder_raises_and_broken_bundle_degrades(tmp_path, monkeypatch):
    """A bundle that fails to load degrades to one SPEAKER_00 turn over the
    timeline in both packages. (Without a bundle the StatsEmbedder runs:
    tests/test_torch_stats_embedder.py.)"""
    monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path))
    broken = tmp_path / "diarization-embedding"
    broken.mkdir()
    (broken / "params.npz").write_bytes(b"not an npz")
    x = jnp.zeros(35 * SR)
    want, _ = jax_diarizer.SpeakerDiarizer().diarize_device_timeline(x, 30 * SR, SR)
    pd = pt_diarizer.SpeakerDiarizer(device="cpu")
    got, _ = pd.diarize_device_timeline(torch.zeros(35 * SR), 30 * SR, SR)
    assert pd._use_noop
    assert [(s.speaker, s.start, s.end) for s in got] == [(s.speaker, s.start, s.end)
                                                          for s in want] == [("SPEAKER_00", 0.0, 30.0)]

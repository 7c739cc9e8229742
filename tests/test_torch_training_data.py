"""The port's training data held against the JAX package.

Host code (the token encoders, the synthetic-ASR generators, the voice
model's conversations) must give equal arrays and equal files. Mels come
from each package's log-mel: within 1e-5 (f32 FFTs in another order) on
the first epoch, and on later epochs from the float16 cache, where a value
within 1e-5 may round to the neighbouring float16 value: within one float16
ulp there.
"""

import json

import numpy as np
import pytest
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.models.whisper.config import WHISPER_DIMS
from modular_audio_pipeline_tpu.models.whisper.tokenizer import DummyTokenizer as JaxDummy
from modular_audio_pipeline_tpu.models.whisper.tokenizer import load_tokenizer as jax_tokenizer
from modular_audio_pipeline_tpu.training import data as jax_data
from modular_audio_pipeline_tpu.training import synth_asr as jax_sa
from modular_audio_pipeline_tpu.training import voices as jax_voices
from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS as PT_DIMS
from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import DummyTokenizer as PtDummy
from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer as pt_tokenizer
from modular_audio_pipeline_tpu_torch.training import data as pt_data
from modular_audio_pipeline_tpu_torch.training import synth_asr as pt_sa
from modular_audio_pipeline_tpu_torch.training import train as pt_train
from modular_audio_pipeline_tpu_torch.training import voices as pt_voices

DIMS = WHISPER_DIMS["test-tiny"]
MEL_TOL = 1e-5


@pytest.fixture(scope="module")
def toks():
    return jax_tokenizer(None, n_vocab=51865), pt_tokenizer(None, n_vocab=51865)


@pytest.mark.parametrize("kw", [
    {}, {"timestamps": True, "duration": 3.21}, {"timestamps": True},
    {"language": "de", "task": "translate", "max_len": 6},
], ids=["plain", "timestamps", "timestamps_no_duration", "cut"])
def test_encode_example_equals_jax(toks, kw):
    jt, pt = toks
    for text in ("hello world", "  alpha bravo charlie  "):
        want = jax_data.encode_example(jt, text, **kw)
        got = pt_data.encode_example(pt, text, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


SEGS = [{"start": 0.10, "end": 4.50, "text": "alpha bravo"},
        {"start": 5.00, "end": 9.20, "text": "charlie"}]


@pytest.mark.parametrize("kw", [
    {"segments": SEGS}, {"segments": SEGS, "tail_start": 25.56},
    {"segments": SEGS[:1], "prompt": "foxtrot golf"},
    {"segments": [{"start": i * 3.0, "end": i * 3.0 + 2.5,
                   "text": "alpha bravo charlie delta echo foxtrot golf hotel"}
                  for i in range(8)], "prompt": "india juliett " * 10, "max_len": 200},
], ids=["pairs", "tail", "prompt", "overflow"])
def test_encode_longform_example_equals_jax(toks, kw):
    jt, pt = toks
    segments = kw.pop("segments")
    want = jax_data.encode_longform_example(jt, segments, **kw)
    got = pt_data.encode_longform_example(pt, segments, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """5 clips: 16 kHz, a 22.05 kHz one (resampled), one longer than 30 s."""
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav

    d = tmp_path_factory.mktemp("manifest")
    rng = np.random.default_rng(0)
    rows = []
    for i, (sr, sec) in enumerate([(16000, 3), (22050, 2), (16000, 31), (16000, 1), (16000, 2)]):
        path = d / f"clip{i}.wav"
        write_wav(str(path), (0.1 * rng.standard_normal(sr * sec)).astype(np.float32), sr)
        rows.append({"audio": str(path), "text": f"hello world number {i}", "duration": sec})
    m = d / "train.jsonl"
    m.write_text("\n".join(json.dumps(r) for r in rows))
    return str(m)


@pytest.mark.parametrize("cache_mels", [False, True], ids=["fresh", "f16_cache"])
def test_dataset_batches_equal_jax_over_two_epochs(manifest, cache_mels):
    jds = jax_data.TranscriptDataset.from_manifest(manifest, JaxDummy(), DIMS, batch_size=2,
                                                   seq_len=32, cache_mels=cache_mels)
    pds = pt_data.TranscriptDataset.from_manifest(manifest, PtDummy(), PT_DIMS["test-tiny"],
                                                  batch_size=2, seq_len=32,
                                                  cache_mels=cache_mels, device="cpu")
    assert len(pds) == len(jds) == 3
    for epoch in (0, 1):
        jb, pb = list(jds.batches(epoch=epoch)), list(pds.batches(epoch=epoch))
        assert len(jb) == len(pb) == 3
        for (jm, jt, jy), (pm, pt, py) in zip(jb, pb):
            assert np.array_equal(pt, jt) and np.array_equal(py, jy)
            assert pm.shape == jm.shape == (2, DIMS.n_mels, 3000) and pm.dtype == np.float32
            if cache_mels and epoch == 1:  # both return their float16 caches
                ulp = np.spacing(np.abs(jm).astype(np.float16)).astype(np.float32)
                assert (np.abs(pm - jm) <= ulp).all()
                assert np.array_equal(pm, pm.astype(np.float16).astype(np.float32))
            else:
                np.testing.assert_allclose(pm, jm, rtol=0, atol=MEL_TOL)


def test_dataset_shapes_and_shuffle(manifest):
    """The JAX package's batch-shape and shuffle tests, on the port."""
    ds = pt_data.TranscriptDataset.from_manifest(manifest, PtDummy(), PT_DIMS["test-tiny"],
                                                 batch_size=2, seq_len=32, device="cpu")
    a = [b[1] for b in ds.batches(epoch=0)]
    b = [b[1] for b in ds.batches(epoch=1)]
    assert not np.array_equal(a[0], b[0])
    assert all(t.shape == (2, 32) for t in a)


def test_longform_manifest_rows_equal_jax(tmp_path, toks):
    """``from_manifest`` keeps rows with segments and encodes them through
    the long-form grammar: one row with segments, one plain."""
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav

    path = tmp_path / "a.wav"
    write_wav(str(path), np.zeros(16000, np.float32), 16000)
    rows = [{"audio": str(path), "text": "alpha", "segments": SEGS, "tail_start": 20.0,
             "prompt": "golf"},
            {"audio": str(path), "text": "bravo charlie"}]
    m = tmp_path / "lf.jsonl"
    m.write_text("\n".join(json.dumps(r) for r in rows))
    jt, pt = toks
    jds = jax_data.TranscriptDataset.from_manifest(str(m), jt, DIMS, batch_size=2, seq_len=64,
                                                   shuffle_seed=None)
    pds = pt_data.TranscriptDataset.from_manifest(str(m), pt, PT_DIMS["test-tiny"], batch_size=2,
                                                  seq_len=64, shuffle_seed=None, device="cpu")
    assert pds.rows is not None
    (_, jt_, jy), (_, pt_, py) = next(jds.batches()), next(pds.batches())
    assert np.array_equal(pt_, jt_) and np.array_equal(py, jy)


def test_pad_batch_rows_are_ignored():
    mel = np.ones((3, 2, 4), np.float32)
    tok = np.ones((3, 5), np.int32)
    y = np.ones((3, 5), np.int32)
    pm, pt, py = pt_train.pad_batch(mel, tok, y, 4)
    assert pm.shape[0] == pt.shape[0] == py.shape[0] == 4
    assert (pm[3] == 0).all() and (pt[3] == 0).all() and (py[3] == -100).all()
    assert pt_train.pad_batch(mel, tok, y, 1)[0] is mel


@pytest.mark.parametrize("idx", [0, 7, 23])
def test_synth_word_and_sentence_bit_equal(idx):
    a = jax_sa.synth_word(idx, np.random.default_rng(idx))
    b = pt_sa.synth_word(idx, np.random.default_rng(idx))
    assert np.array_equal(a, b)
    words = [idx, (idx + 5) % 24, 3]
    assert np.array_equal(jax_sa.synth_sentence(words, np.random.default_rng(1)),
                          pt_sa.synth_sentence(words, np.random.default_rng(1)))


@pytest.mark.parametrize("maker", ["make_dataset", "make_longform_dataset",
                                   "make_midstream_dataset"])
def test_synth_asr_datasets_bit_equal(tmp_path, maker):
    from modular_audio_pipeline_tpu.audio_io import read_wav

    kw = dict(n_train=2, n_eval=1, seed=3)
    jm = getattr(jax_sa, maker)(str(tmp_path / "jax"), **kw)
    pm = getattr(pt_sa, maker)(str(tmp_path / "port"), **kw)
    for j, p in zip(jm, pm):
        jrows = [json.loads(line) for line in open(j) if line.strip()]
        prows = [json.loads(line) for line in open(p) if line.strip()]
        assert len(jrows) == len(prows) > 0
        for a, b in zip(jrows, prows):
            wa, wb = a.pop("audio"), b.pop("audio")
            assert a == b
            assert np.array_equal(read_wav(wa)[0], read_wav(wb)[0])


def test_synth_conversation_bit_equal():
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    va = [jax_voices.sample_voice(rng_a) for _ in range(3)]
    vb = [pt_voices.sample_voice(rng_b) for _ in range(3)]
    turns = [(0, 2.0), (1, 1.5), (2, 2.5), (0, 1.0)]
    a, ta = jax_voices.synth_conversation(va, turns, rng_a, overlap_prob=0.5, noise_level=0.004,
                                          gap_s=0.1)
    b, tb = pt_voices.synth_conversation(vb, turns, rng_b, overlap_prob=0.5, noise_level=0.004,
                                         gap_s=0.1)
    assert np.array_equal(a, b) and ta == tb

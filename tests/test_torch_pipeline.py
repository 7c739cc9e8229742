"""The port's AudioPipeline held against the JAX package's, end to end on
the CPU.

Both pipelines run the same files with the same configuration: the
fixtures and config of tests/test_pipeline_e2e.py (test-tiny, its random
weights carried across with ``params_from_numpy``), both transcription
backends, and the shipped proxy bundle on its held-out sentences; in
float32 (XLA on the CPU has no batched bf16 product). The stages between
them hand over published buffers in both packages. Equal means equal:
the silence and VAD mappings, the output JSON with its speakers, the
segments and the result's keys. Then the wiring: injected stages, the
NoOps, failure results, ``run_transcription_only``, ``cleanup``, the
profiler trace, and the options that raise.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from test_pipeline_e2e import fast_config, make_speechy_wav
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.pipeline import AudioPipeline as JaxPipeline
from modular_audio_pipeline_tpu_torch.config import PipelineConfig
from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
from modular_audio_pipeline_tpu_torch.pipeline import AudioPipeline
from modular_audio_pipeline_tpu_torch.protocols import DiarizationSegment
from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

SR = 16000


def port_config(jcfg, media_dir):
    """The port's PipelineConfig of a JAX config, on its own media dir."""
    data = {k: v for k, v in jcfg.to_dict().items() if k not in ("temp_dir", "results_dir")}
    data["media_dir"] = str(media_dir)
    cfg = PipelineConfig.from_dict(data)
    cfg.temp_dir = cfg.results_dir = None  # derived under media_dir, as the JAX config's
    cfg.__post_init__()
    return cfg


def recorded(pipe):
    """Record the silence and VAD stages' mappings of each run."""
    seen = {}
    for owner, name in ((pipe.preprocessor, "remove_silence"), (pipe.vad, "filter_voice")):
        real = getattr(owner, name)

        def spy(*a, _real=real, _name=name, **kw):
            out = _real(*a, **kw)
            seen[_name] = [dataclasses.astuple(m) for m in out[1]]
            return out

        setattr(owner, name, spy)
    return seen


def pair(tmp_path, wav_maker, carry=True, **overrides):
    """(JAX pipeline, port pipeline) over two media dirs holding the same
    file; the port's transcriber holds the JAX transcriber's weights."""
    dirs = [tmp_path / "jax", tmp_path / "pt"]
    for d in dirs:
        d.mkdir()
        wav_maker(d)
    jcfg = fast_config(dirs[0], **{"transcription.compute_type": "float32", **overrides})
    jp = JaxPipeline(jcfg)
    pp = AudioPipeline(port_config(jcfg, dirs[1]), device="cpu")
    if carry:
        jp.transcriber.load_model()
        pp.transcriber.load_model()
        pp.transcriber._backend.params = params_from_numpy(
            jax.tree.map(np.asarray, jp.transcriber._backend.params), "cpu", torch.float32)
    return jp, pp


def run_both(jp, pp, input_file=None):
    seen_j, seen_p = recorded(jp), recorded(pp)
    out_j, out_p = jp.run(input_file), pp.run(input_file)
    assert out_j.success and out_p.success, (out_j.error, out_p.error)
    doc_j = json.loads(open(out_j.output_file, encoding="utf-8").read())
    doc_p = json.loads(open(out_p.output_file, encoding="utf-8").read())
    doc_j["metadata"].pop("source_file")
    assert os.path.basename(doc_p["metadata"].pop("source_file")) == os.path.basename(
        out_j.input_file)
    assert doc_p == doc_j
    assert seen_p == seen_j
    assert out_p.segments == out_j.segments
    assert set(out_p.metadata) == set(out_j.metadata)
    assert set(out_p.metadata["stage_timings"]) == set(out_j.metadata["stage_timings"])
    return out_p, doc_p, seen_p


@pytest.mark.parametrize("backend", ["faster-whisper", "openai"])
def test_test_tiny_run_equals_jax(tmp_path, backend):
    """The e2e fixture (35 s, so that random weights leave segments), both
    backends: JSON with speakers, segments and mappings equal."""
    jp, pp = pair(tmp_path, lambda d: make_speechy_wav(str(d / "recording.wav"), 35.0),
                  **{"transcription.backend": backend})
    out, doc, seen = run_both(jp, pp)
    assert doc["segments"] and any(s["speaker"].startswith("SPEAKER_") for s in doc["segments"])
    assert seen["remove_silence"] and seen["filter_voice"]
    assert type(pp.transcriber).__name__ == {"faster-whisper": "FasterWhisperTranscriber",
                                             "openai": "WhisperTranscriber"}[backend]
    assert type(pp.vad).__name__ == "SileroVADFilter" and pp.vad.last_cut in ("device", "host")


def proxy_wav(d):
    """The proxy bundle's two held-out sentences in one file with silent
    gaps (as tests/test_torch_serving.py builds it)."""
    from modular_audio_pipeline_tpu.audio_io import write_wav
    from modular_audio_pipeline_tpu.training.synth_asr import VOCAB, synth_sentence

    rng = np.random.default_rng(500_000)
    sentences = []
    for _ in range(2):
        k = int(rng.integers(12, 27))
        sentences.append(synth_sentence(list(rng.integers(0, len(VOCAB), size=k)), rng))
    gap, edge = np.zeros(2 * SR, np.float32), np.zeros(SR, np.float32)
    write_wav(str(d / "proxy.wav"), np.concatenate([edge, sentences[0], gap, sentences[1], edge]), SR)


def test_proxy_sentences_equal_jax(tmp_path):
    """The trained proxy bundle (read from disk by both), merging off so
    the segments keep their back-mapped times: equal JSON."""
    jp, pp = pair(tmp_path, proxy_wav, carry=False, **{
        "transcription.model": "tiny", "transcription.beam_size": 5, "transcription.batch_size": 16,
        "transcription.max_decode_tokens": 128,
        "transcription.weights_path": str(SHIPPED_WEIGHTS / "whisper-tiny-synth-proxy"),
        "segment_merging.enabled": False})
    out, doc, seen = run_both(jp, pp)
    assert doc["segments"] and all({"original_start", "original_end"} <= set(s)
                                   for s in doc["segments"])
    assert "oscar" in " ".join(s["text"] for s in doc["segments"])


def test_noops_and_injection(tmp_path):
    """Stages turned off take the NoOps, as in the JAX package (equal
    JSON); injected stages are used."""
    off = {"vad.enabled": False, "noise_reduction.enabled": False,
           "diarization.enabled": False, "redundancy.enabled": False}
    jp, pp = pair(tmp_path, lambda d: make_speechy_wav(str(d / "recording.wav"), 8.0), **off)
    for attr in ("vad", "diarizer", "redundancy", "separator"):
        assert type(getattr(pp, attr)).__name__ == type(getattr(jp, attr)).__name__
        assert type(getattr(pp, attr)).__name__.startswith("NoOp")
    run_both(jp, pp)

    class FakeTranscriber:
        def transcribe(self, input_wav):
            return {"text": "hello world", "language": "en", "duration": 2.0,
                    "segments": [{"start": 0.0, "end": 2.0, "text": "hello world"}]}

        def is_loaded(self):
            return True

        def load_model(self):
            pass

    class FakeDiarizer:
        def diarize(self, audio_path, min_speakers=2, max_speakers=5):
            assert os.path.exists(audio_path)  # flushed for a stage without buffers
            return [DiarizationSegment("SPEAKER_07", 0.0, 5.0)]

    cfg = port_config(fast_config(tmp_path / "pt"), tmp_path / "pt")
    pipe = AudioPipeline(cfg, transcriber=FakeTranscriber(), diarizer=FakeDiarizer(), device="cpu")
    result = pipe.run()
    assert result.success, result.error
    assert result.segments[0]["speaker"] == "SPEAKER_07"
    assert result.segments[0]["text"] == "hello world"


def test_failures_transcription_only_and_cleanup(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    pipe = AudioPipeline(port_config(fast_config(empty), empty), device="cpu")
    result = pipe.run()
    assert not result.success and "No valid media file" in result.error
    result = pipe.run(input_file="nope.wav")
    assert not result.success and "not found" in result.error.lower()
    assert result.output_file is None and result.segments == []

    media = tmp_path / "media"
    media.mkdir()
    make_speechy_wav(str(media / "recording.wav"), 8.0)
    cfg = port_config(fast_config(media), media)
    cfg.tpu.profile_dir = str(tmp_path / "trace")
    pipe = AudioPipeline(cfg, device="cpu")
    only = pipe.run_transcription_only(str(media / "recording.wav"))
    assert only.success and only.output_file is None and isinstance(only.segments, list)
    result = pipe.run()
    assert result.success, result.error
    assert os.listdir(tmp_path / "trace")  # the torch.profiler trace
    assert os.path.exists(cfg.temp_dir) and pipe.transcriber.is_loaded()
    pipe.cleanup()
    assert not os.path.exists(cfg.temp_dir) and not pipe.transcriber.is_loaded()
    shutil.rmtree(tmp_path / "trace")


@pytest.mark.parametrize("option", ["mesh"])
def test_unported_options_raise(tmp_path, option):
    """A ``tpu.mesh_shape`` reaches the transcriber's mesh, as in the JAX
    package; larger than the world of ranks (one process here) it raises
    ``ShardingError`` naming the torchrun launch."""
    from modular_audio_pipeline_tpu_torch.exceptions import ShardingError

    cfg = port_config(fast_config(tmp_path), tmp_path)
    cfg.tpu.mesh_shape = {"data": 2}
    with pytest.raises(ShardingError, match="torchrun"):
        AudioPipeline(cfg, device="cpu")

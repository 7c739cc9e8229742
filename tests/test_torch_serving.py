"""The port's ServingPipeline (process and run_file) held against the JAX
package's, end to end on the CPU.

Both pipelines run in float32 with the shipped ConvVAD and diarization
bundles. The port's Whisper backend carries the JAX backend's weights
across (``params_from_numpy``), so the two decode the same model. Equal
means equal: keep intervals and ``timestamp_mappings``, ``kept_duration``,
``decode_stats``, segments (text, start, end, words), diarization turns and
``run_file``'s JSON; the segment confidences (mean token log-probabilities)
agree to 5e-4, as in tests/test_torch_transcriber.py.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from test_serving import make_audio
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu import serving as jax_serving
from modular_audio_pipeline_tpu.config import PipelineConfig as JaxConfig
from modular_audio_pipeline_tpu_torch import serving as pt_serving
from modular_audio_pipeline_tpu_torch.config import PipelineConfig
from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend
from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

SR = 16000
PROXY = SHIPPED_WEIGHTS / "whisper-tiny-synth-proxy"


def configure(cfg, model="test-tiny", weights="random:0", tokens=32, words=True, batch=4,
              language="en", compute="float32"):
    t = cfg.transcription
    t.model, t.weights_path, t.language, t.compute_type = model, weights, language, compute
    t.beam_size, t.max_decode_tokens, t.batch_size = 5, tokens, batch
    t.word_timestamps = words
    t.no_speech_threshold = None  # every window is parsed, as bench.py
    return cfg


def pair(model="test-tiny", weights="random:0", tokens=32, words=True, batch=4, diarize=True,
         edit=lambda cfg: None, language="en", compute_dtype="float32"):
    """(JAX pipeline, port pipeline) of one configuration; the port's
    backend holds the JAX backend's weights. ``compute_dtype="int8"``
    loads float32 weights and quantises the decoder, in both packages (the
    paired tests run float32 activations: XLA on the CPU has no batched
    bf16 product)."""
    jcfg = configure(JaxConfig(media_dir="/tmp"), model, weights, tokens, words, batch,
                     language, compute_dtype)
    pcfg = configure(PipelineConfig(), model, weights, tokens, words, batch, language,
                     compute_dtype)
    edit(jcfg)
    edit(pcfg)
    jp = jax_serving.ServingPipeline(jcfg, diarize=diarize)
    jp.backend.compute_dtype = "float32"
    jp.backend.load()
    jp.backend.compute_dtype = compute_dtype
    jp.backend._maybe_quantize()
    t = pcfg.transcription
    backend = TorchWhisperBackend(
        t.model, language=language, beam_size=5, weights_path=weights,
        compute_dtype="float32", batch_size=batch, max_decode_tokens=tokens,
        word_timestamps=words, no_speech_threshold=None, device="cpu")
    backend.load()
    backend.compute_dtype = compute_dtype
    backend.params = params_from_numpy(jax.tree.map(np.asarray, jp.backend.params), "cpu",
                                       torch.float32)
    return jp, pt_serving.ServingPipeline(pcfg, backend=backend, diarize=diarize, device="cpu")


def mappings(result):
    return [dataclasses.astuple(m) for m in result["timestamp_mappings"]]


def segments(result):
    return [(s["text"], s["start"], s["end"],
             [(w["word"], w["start"], w["end"]) for w in s.get("words", [])])
            for s in result["segments"]]


def run_file_and_process(pipe, wav, results_dir):
    """run_file's PipelineResult and JSON document, and the process()
    result it was made from."""
    seen = []
    real = pipe.process
    pipe.process = lambda audio, sr: seen.append(real(audio, sr)) or seen[-1]
    try:
        out = pipe.run_file(str(wav), str(results_dir))
    finally:
        del pipe.process
    assert out.success, out.error
    return out, json.loads(open(out.output_file, encoding="utf-8").read()), seen[0]


def assert_equal_results(got, want, confidence_tol=5e-4):
    assert set(got) == set(want)
    assert mappings(got) == mappings(want)
    for key in ("kept_duration", "decode_stats", "diarization", "duration", "language",
                "text", "vocal_separation"):
        assert got[key] == want[key], key
    assert segments(got) == segments(want)
    np.testing.assert_allclose([s["confidence"] for s in got["segments"]],
                               [s["confidence"] for s in want["segments"]], rtol=0,
                               atol=confidence_tol)


@pytest.fixture(scope="module")
def tiny_pair():
    return pair()


def check_test_tiny(jp, pp, tmp_path, confidence_tol=5e-4):
    """process and run_file of both pipelines on 70 s of voiced audio as
    int16 PCM: equal results and JSON."""
    from modular_audio_pipeline_tpu.audio_io import write_wav

    audio = np.round(make_audio(70.0) * 32767).astype(np.int16)
    wav = tmp_path / "voiced.wav"
    write_wav(str(wav), audio.astype(np.float32) / 32768.0, SR)  # read back as int16
    out_j, doc_j, want = run_file_and_process(jp, wav, tmp_path / "jax")
    out_p, doc_p, got = run_file_and_process(pp, wav, tmp_path / "pt")
    assert want["kept_duration"] > 0 and want["segments"] and want["diarization"]
    assert any(s.get("words") for s in want["segments"]) == pp.word_timestamps
    assert_equal_results(got, want, confidence_tol)
    assert type(pp._vad_model).__name__ == "ConvVAD"
    assert pp._diarizer._segmentation is not None and not pp._diarizer._use_noop
    assert doc_p == doc_j and doc_j["segments"]
    assert out_p.segments == out_j.segments
    assert set(out_p.metadata) == set(out_j.metadata)
    return got


def test_test_tiny_process_and_run_file_equal_jax(tiny_pair, tmp_path):
    """test-tiny, random weights carried across, 70 s of voiced audio as
    int16 PCM (converted on the device), the default VAD (ConvVAD bundle),
    denoise, diarization and word timestamps."""
    check_test_tiny(*tiny_pair, tmp_path)


def test_test_tiny_language_auto_equal_jax(tmp_path):
    """The same file and configuration with ``language="auto"``: language
    detection on the first kept window inside ``process``."""
    got = check_test_tiny(*pair(language="auto"), tmp_path)
    assert got["language"] != "auto"


def test_silent_audio_takes_the_early_return(tiny_pair):
    jp, pp = tiny_pair
    audio = np.zeros(35 * SR, np.float32)
    want, got = jp.process(audio, SR), pp.process(audio, SR)
    assert want["kept_duration"] == 0.0
    assert_equal_results(got, want)


def check_proxy(tmp_path, compute_dtype="float32", confidence_tol=5e-4):
    """The shipped proxy bundle on its two held-out sentences in one file
    with silent gaps, the default (ConvVAD) VAD: the JAX result is not
    trivial, and the port's equals it, run_file's JSON with the mappings
    back to the original audio (segment merging off, which drops them)."""
    from modular_audio_pipeline_tpu.audio_io import write_wav
    from modular_audio_pipeline_tpu.training.synth_asr import VOCAB, synth_sentence

    rng = np.random.default_rng(500_000)  # the proxy's held-out stream
    sentences = []
    for _ in range(2):
        k = int(rng.integers(12, 27))
        sentences.append(synth_sentence(list(rng.integers(0, len(VOCAB), size=k)), rng))
    gap, edge = np.zeros(2 * SR, np.float32), np.zeros(SR, np.float32)
    audio = np.concatenate([edge, sentences[0], gap, sentences[1], edge])

    def no_merge(cfg):
        cfg.segment_merging.enabled = False

    jp, pp = pair("tiny", str(PROXY), tokens=128, batch=16, edit=no_merge,
                  compute_dtype=compute_dtype)
    wav = tmp_path / "proxy.wav"
    write_wav(str(wav), audio, SR)
    _, doc_j, want = run_file_and_process(jp, wav, tmp_path / "jax")
    _, doc_p, got = run_file_and_process(pp, wav, tmp_path / "pt")
    assert want["kept_duration"] > 0 and want["segments"] and want["diarization"]
    assert all(s.get("words") for s in want["segments"])
    assert_equal_results(got, want, confidence_tol)
    if compute_dtype == "float32":
        assert doc_p == doc_j
    else:  # equal but for the confidences, held to confidence_tol above
        def drop(doc):
            return {**doc, "segments": [{k: v for k, v in s.items() if k != "confidence"}
                                        for s in doc["segments"]]}

        assert drop(doc_p) == drop(doc_j)
    assert all({"original_start", "original_end"} <= set(s) for s in doc_j["segments"])
    return pp


def test_proxy_sentences_equal_jax(tmp_path):
    check_proxy(tmp_path)


def test_proxy_sentences_int8_equal_jax(tmp_path, monkeypatch):
    """The same with the int8 decoder (``compute_type="int8"``) inside
    ``process``. On the CPU the JAX package's int8 product takes its XLA
    branch, which rounds each dequantised weight to bf16; it is bound here
    to its Pallas kernel's arithmetic, which the port's plain version
    follows (tests/test_torch_quant.py). Segments and words are equal, the
    confidences agree to 2e-3. (On test-tiny's random weights the int8
    decode is not comparable: both round the activations to bf16, values
    1e-6 apart round to neighbouring bf16 values now and then, and near-flat
    logits and attention turn that into other beams and DTW paths; with the
    products in f32 test-tiny is equal too. ROADMAP.md §C.)"""
    from test_torch_quant import _kernel_arithmetic

    from modular_audio_pipeline_tpu.ops import quant as jax_quant

    monkeypatch.setattr(jax_quant, "int8_matmul", _kernel_arithmetic)
    pp = check_proxy(tmp_path, "int8", confidence_tol=2e-3)
    assert "logits_wq" in pp.backend.params["decoder"]


@pytest.mark.parametrize("provider", ["webrtc", "energy"])
def test_other_vad_providers_keep_the_same_audio(provider, tmp_path, monkeypatch):
    """The "webrtc" provider (band statistics, hangover machine) and the
    energy-probability VAD that runs without a bundle, on 8 kHz input
    (resampled on the host): keep intervals, decode and segments equal."""
    from modular_audio_pipeline_tpu.audio_io import resample_poly

    def edit(cfg):
        cfg.vad.provider = "webrtc" if provider == "webrtc" else "silero"

    if provider == "energy":
        monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path))  # no bundle anywhere
    jp, pp = pair(tokens=8, words=False, diarize=False, edit=edit)
    audio = resample_poly(make_audio(40.0, seed=2), SR, 8000)
    want = jp.process(audio, 8000)
    got = pp.process(audio, 8000)
    assert pp._vad_model is None
    assert 0 < want["kept_duration"] < 40.0
    assert_equal_results(got, want)


def test_sectioned_dsp_matches_the_whole_file(monkeypatch):
    """Inputs longer than one DSP section run section by section; with the
    section forced to 25 s in both packages, the 70 s file (a 300 s bucket)
    gives the same keep intervals as in one section, and the port's equal
    the JAX package's (denoise off: per-section noise profiles are a
    separate, documented approximation)."""
    rng = np.random.default_rng(5)
    n = int(70 * SR)
    t = np.arange(n) / SR
    f0 = 150 + 25 * np.sin(2 * np.pi * 0.6 * t)
    audio = sum((0.3 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / SR) for k in range(1, 5))
    audio = (audio * (np.sin(2 * np.pi * 0.7 * t) > -0.3)).astype(np.float32)
    audio += 0.002 * rng.standard_normal(n).astype(np.float32)

    def edit(cfg):
        cfg.noise_reduction.enabled = False

    jp, pp = pair(tokens=8, words=False, diarize=False, edit=edit)
    whole = [jp.process(audio, SR), pp.process(audio, SR)]
    monkeypatch.setattr(jax_serving, "_DSP_SECTION_S", 25)
    monkeypatch.setattr(pt_serving, "_DSP_SECTION_S", 25)
    sectioned = [jp.process(audio, SR), pp.process(audio, SR)]
    assert mappings(whole[0]) and mappings(sectioned[0]) == mappings(whole[0])
    assert mappings(sectioned[1]) == mappings(whole[1]) == mappings(whole[0])
    assert_equal_results(sectioned[1], sectioned[0])


def test_default_device_is_cuda(tmp_path):
    """ServingPipeline, AudioPipeline, the stages (preprocessor, VAD
    filters, FasterWhisperTranscriber), the BatchDriver, the diarizer, the
    separator, the separation backend, the networks and the StatsEmbedder
    target CUDA when no device is given, and raise on a machine without it;
    so do the weight-free REPET, music test and frame classifier, whose
    results are host arrays. The CLI, which takes no device flag, exits 1
    there."""
    from test_torch_silero import synthetic_state_dict

    from modular_audio_pipeline_tpu_torch.diarizer import SpeakerDiarizer
    from modular_audio_pipeline_tpu_torch.models.diarization.embedding import (
        ConvEmbedder,
        StatsEmbedder,
    )
    from modular_audio_pipeline_tpu_torch.models.diarization.segmentation import SegmentationNet
    from modular_audio_pipeline_tpu_torch.models.separation.repet import repet_separate
    from modular_audio_pipeline_tpu_torch.models.separation.unet import MaskUNet
    from modular_audio_pipeline_tpu_torch.models.silero_convert import convert_state_dict
    from modular_audio_pipeline_tpu_torch.models.vad_net import ConvVAD, SileroVAD
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params
    from modular_audio_pipeline_tpu_torch.ops.music import analyze_audio_content
    from modular_audio_pipeline_tpu_torch.separator import VocalSeparator, get_separation_backend
    from modular_audio_pipeline_tpu_torch.ops.vad_ops import frame_speech_flags
    from modular_audio_pipeline_tpu_torch.parallel.batch import BatchDriver
    from modular_audio_pipeline_tpu_torch.pipeline import AudioPipeline
    from modular_audio_pipeline_tpu_torch.preprocessor import AudioPreprocessor
    from modular_audio_pipeline_tpu_torch.transcriber import FasterWhisperTranscriber
    from modular_audio_pipeline_tpu_torch.vad import SileroVADFilter, VADFilter, load_vad_model

    media = tmp_path / "media"
    media.mkdir()
    cfg = configure(PipelineConfig(media_dir=str(media)))

    holders = [
        lambda: pt_serving.ServingPipeline(),
        lambda: SpeakerDiarizer(),
        lambda: load_vad_model(),
        lambda: ConvVAD(load_params(str(SHIPPED_WEIGHTS / "vad-silero"))),
        lambda: SegmentationNet(load_params(str(SHIPPED_WEIGHTS / "diarization-segmentation"))),
        lambda: ConvEmbedder(load_params(str(SHIPPED_WEIGHTS / "diarization-embedding"))),
        lambda: SileroVAD(convert_state_dict(synthetic_state_dict())),
        lambda: MaskUNet(load_params(str(SHIPPED_WEIGHTS / "separation-htdemucs"))),
        lambda: StatsEmbedder(),
        lambda: VocalSeparator(SR, str(tmp_path / "sep")),
        lambda: get_separation_backend("htdemucs").__self__,  # the bundle's MaskUNet
        lambda: AudioPipeline(cfg),
        lambda: AudioPreprocessor(SR, str(tmp_path / "pre")),
        lambda: VADFilter(),
        lambda: SileroVADFilter(),
        lambda: FasterWhisperTranscriber("test-tiny"),
        lambda: BatchDriver(cfg),
    ]
    weight_free = [
        lambda: repet_separate(np.zeros(SR, np.float32), SR),
        lambda: analyze_audio_content(np.zeros(SR, np.float32), SR),
        lambda: frame_speech_flags(np.zeros(SR, np.float32), SR),
    ]
    for build in holders + weight_free:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                build()
        elif build in weight_free:
            build()
        else:
            obj = build()
            dev = obj[0] if isinstance(obj, tuple) else obj
            if isinstance(dev, torch.nn.Module):
                tensors = list(dev.parameters()) + list(dev.buffers())
                assert tensors and all(t.device.type == "cuda" for t in tensors)
            else:
                assert dev.device.type == "cuda"
    if not torch.cuda.is_available():
        from modular_audio_pipeline_tpu_torch import cli

        wav = media / "rec.wav"
        from modular_audio_pipeline_tpu_torch.audio_io import write_wav

        write_wav(str(wav), np.zeros(SR, np.float32), SR)
        assert cli.main(["--media-dir", str(media), "--model", "test-tiny",
                         "--weights-dir", "random:0"]) == 1


@pytest.mark.parametrize("option", ["mesh", "mesh_shape"])
def test_unported_options_raise(option):
    """The mesh options, now ported, refuse what cannot run: a ``mesh`` that
    is not a ``DeviceMesh`` (``TypeError``), and a ``tpu.mesh_shape`` larger
    than the world of ranks (here one process: ``ShardingError`` naming the
    torchrun launch, as the JAX package raises for too few devices)."""
    from modular_audio_pipeline_tpu_torch.exceptions import ShardingError

    cfg = configure(PipelineConfig())
    mesh = None
    if option == "mesh":
        mesh, error, match = object(), TypeError, "DeviceMesh"
    else:
        cfg = configure(JaxConfig(media_dir="/tmp"))
        cfg.tpu.mesh_shape = {"data": 2}
        error, match = ShardingError, "torchrun"
    with pytest.raises(error, match=match):
        pipe = pt_serving.ServingPipeline(cfg, device="cpu", mesh=mesh)
        pipe.process(np.zeros(SR, np.float32), SR)

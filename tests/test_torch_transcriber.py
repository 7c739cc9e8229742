"""The PyTorch port's transcriber held against the JAX package's, and the
port's import boundary.

The shipped proxy bundle (``weights/whisper-tiny-synth-proxy``) decodes the
held-out synthetic sentences of tests/test_synth_asr_regression.py through
both ``WhisperTranscriber``s (float32, beam 5, 128 tokens, int8 KV cache,
segment timestamps); the segments must be equal, also with DTW words and
with the int8 decoder. The temperature ladder, whose samples cannot equal
the JAX package's (another generator), is held to its control flow.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
BUNDLE = ROOT / "modular_audio_pipeline_tpu/weights/whisper-tiny-synth-proxy"


@pytest.fixture(scope="module")
def eval_sentences(tmp_path_factory):
    """The two held-out sentences of test_synth_asr_regression.py."""
    from modular_audio_pipeline_tpu.audio_io import write_wav
    from modular_audio_pipeline_tpu.training.synth_asr import SR, VOCAB, synth_sentence

    root = tmp_path_factory.mktemp("torch_synth_eval")
    rng = np.random.default_rng(500_000)  # the eval stream seed
    out = []
    for i in range(2):
        k = int(rng.integers(12, 27))
        words = rng.integers(0, len(VOCAB), size=k)
        path = root / f"eval_{i}.wav"
        write_wav(str(path), synth_sentence(list(words), rng), SR)
        out.append(str(path))
    return out


def _key(segments):
    return [(s["text"], s["start"], s["end"]) for s in segments]


def test_proxy_bundle_segments_equal_jax(eval_sentences):
    from modular_audio_pipeline_tpu.transcriber import WhisperTranscriber as JaxTranscriber
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    kw = dict(model_name="tiny", language="en", beam_size=5, weights_path=str(BUNDLE),
              word_timestamps=False, max_decode_tokens=128)
    jax_tr = JaxTranscriber(**kw)
    jax_tr._backend.compute_dtype = "float32"
    pt_tr = WhisperTranscriber(**kw, device="cpu")
    pt_tr._backend.compute_dtype = "float32"
    for path in eval_sentences:
        want = jax_tr.transcribe(path)
        got = pt_tr.transcribe(path)
        assert got["segments"], f"no segments for {path}"
        assert _key(got["segments"]) == _key(want["segments"])
        assert got["text"] == want["text"]
        # confidence = mean token log-prob; the logits behind it agree to
        # ~1e-4 (f32 sums in another order through 4+4 layers)
        np.testing.assert_allclose(
            [s["confidence"] for s in got["segments"]],
            [s["confidence"] for s in want["segments"]], rtol=0, atol=5e-4)


def test_default_device_is_cuda():
    """device=None means CUDA, for the transcriber, the serving pipeline and
    the diarizer: without a CUDA device they raise instead of running on
    the CPU (tests/test_torch_serving.py covers the networks)."""
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    from modular_audio_pipeline_tpu_torch.diarizer import SpeakerDiarizer
    from modular_audio_pipeline_tpu_torch.serving import ServingPipeline

    if torch.cuda.is_available():
        assert WhisperTranscriber()._backend.device.type == "cuda"
        assert ServingPipeline().device.type == SpeakerDiarizer().device.type == "cuda"
    else:
        for build in (WhisperTranscriber, ServingPipeline, SpeakerDiarizer):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()


@pytest.mark.parametrize("option, value", [
    ("word_timestamps", True),
    ("compute_dtype", "int8"),
    ("temperature", 0.4),
    ("language", "auto"),
    ("language", None),
])
def test_ported_options_run(tmp_path, option, value):
    """Options that used to raise: each transcribes 35 s of noise at
    test-tiny (random weights) into well-formed segments."""
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import LANGUAGES
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    wav = tmp_path / "noise.wav"
    noise = 0.1 * np.random.default_rng(30).standard_normal(16000 * 35).astype(np.float32)
    write_wav(str(wav), noise, 16000)
    tr = WhisperTranscriber("test-tiny", language="en", weights_path="random:0", device="cpu",
                            max_decode_tokens=12, word_timestamps=False)
    backend = tr._backend
    backend.compute_dtype = "float32"
    backend.no_speech_threshold = None
    setattr(backend, option, value)
    out = tr.transcribe(str(wav))
    assert backend.last_stats["windows"] == 2 and out["segments"]
    assert out["language"] in LANGUAGES
    for seg in out["segments"]:
        assert 0.0 <= seg["start"] <= seg["end"] <= 35.0 and np.isfinite(seg["confidence"])
    if option == "word_timestamps":
        words = [w for seg in out["segments"] for w in seg.get("words", [])]
        assert words and all(0.0 <= w["start"] <= w["end"] <= 35.0 for w in words)
        assert backend.last_stats["align_s"] > 0
    if option == "compute_dtype":
        blocks = backend.params["decoder"]["blocks"]
        assert blocks["attn"]["q_wq"].dtype == torch.int8 and "q_w" not in blocks["attn"]
        assert blocks["mlp"]["fc1_ws"].dtype == torch.float32
        assert "logits_wq" in backend.params["decoder"]


def test_from_config_reads_either_package_config():
    from modular_audio_pipeline_tpu.config import PipelineConfig as JaxConfig
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    for cfg in (PipelineConfig(), JaxConfig(media_dir=str(ROOT))):
        cfg.transcription.model = "test-tiny"
        cfg.transcription.compute_type = "float32"
        cfg.transcription.patience = 2.0
        cfg.transcription.word_timestamps = False
        tr = WhisperTranscriber.from_config(cfg, device="cpu")
        b = tr._backend
        assert (b.model_name, b.compute_dtype, b.patience, b.kv_cache_dtype) == (
            "test-tiny", "float32", 2.0, "int8")
        assert not tr.is_loaded()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import modular_audio_pipeline_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "pkg.WhisperTranscriber, pkg.ServingPipeline\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] in ('jaxlib', 'modular_audio_pipeline_tpu'))\n"
        "assert len(names) >= 77, names\n"
        "assert {'serving', 'diarizer', 'vad', 'models.vad_net', 'models.diarization.segmentation',\n"
        "        'models.diarization.embedding', 'separator', 'ops.music', 'models.separation',\n"
        "        'models.separation.repet', 'models.separation.unet', 'models.silero_convert',\n"
        "        'pipeline', 'preprocessor', 'media_handler', 'cli', '__main__', 'parallel.batch',\n"
        "        'runtime.native_lib', 'runtime.prefetch', 'ops.dynamics', 'ops.silence',\n"
        "        'ops.loudness', 'audio_io', 'protocols', 'exceptions', 'streaming',\n"
        "        'post_processing', 'post_processing_hybrid', 'models.lm', 'models.lm.llama',\n"
        "        'evaluation', 'evaluation.metrics', 'training', 'training.optim',\n"
        "        'training.whisper_train', 'training.data', 'training.train', 'training.voices',\n"
        "        'training.synth_asr', 'training.vad', 'training.diarization',\n"
        "        'training.separation', 'runtime.integrity', 'parallel.mesh',\n"
        "        'parallel.sharding',\n"
        "        } <= {n.split('.', 1)[1] for n in names}, names\n"
        "pkg.AudioPipeline, pkg.BatchDriver, pkg.FasterWhisperTranscriber\n"
        "for name in pkg.__all__: getattr(pkg, name)\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _ladder_backend(tmp_path, seconds=1.0):
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    wav = tmp_path / "tone.wav"
    n = int(16000 * seconds)
    write_wav(str(wav), 0.1 * np.sin(np.arange(n) / 5.0).astype(np.float32), 16000)
    tr = WhisperTranscriber("test-tiny", language="en", device="cpu", max_decode_tokens=4,
                            word_timestamps=False,
                            weights_path=str(ROOT / "modular_audio_pipeline_tpu/weights/whisper-test-tiny"))
    tr._backend.compute_dtype = "float32"
    tr._backend.no_speech_threshold = None
    return tr, str(wav)


def test_temperature_ladder_retries_and_keeps_the_last_rung(tmp_path, monkeypatch):
    """A window failing whisper's quality gates goes up the sampling ladder;
    with a log-probability threshold no decode can reach, it walks all five
    rungs, the last rung's result is kept, and a second run is identical."""
    from modular_audio_pipeline_tpu_torch import transcriber as mod

    tr, wav = _ladder_backend(tmp_path)
    tr._backend.logprob_threshold = 10.0  # average log-probabilities are <= 0
    calls = []
    real = mod.decode_windows

    def spy(params, dims, tok, mel, opts, rng=None, audio_kv=None):
        res = real(params, dims, tok, mel, opts, rng=rng, audio_kv=audio_kv)
        calls.append((opts.temperature, opts.beam_size, mel.shape[0],
                      None if rng is None else rng.initial_seed(), res))
        return res

    monkeypatch.setattr(mod, "decode_windows", spy)
    first = tr.transcribe(wav)
    assert [(c[0], c[1], c[2]) for c in calls] == [
        (0.0, 5, 1), (0.2, 1, 1), (0.4, 1, 1), (0.6, 1, 1), (0.8, 1, 1), (1.0, 1, 1)]
    assert [c[3] for c in calls] == [None, 1000, 1001, 1002, 1003, 1004]
    assert tr._backend.last_stats["retried_windows"] == 1
    last = calls[-1][4]
    want = tr._backend._parse_window(last.tokens[0], float(last.avg_logprobs[0]), 0.0, 1.0)
    assert first["segments"] == want
    calls.clear()
    assert tr.transcribe(wav) == first
    assert len(calls) == 6


def test_temperature_ladder_control_flow_on_scripted_results(tmp_path, monkeypatch):
    """Three of four windows fail at temperature 0; scripted retries pass
    window 3 at the first rung and window 0 at the third, and never pass
    window 2: each rung decodes only what still fails, padded to a batch
    bucket by repeating the last row, and the last rung's result stays."""
    from modular_audio_pipeline_tpu_torch import transcriber as mod
    from modular_audio_pipeline_tpu_torch.models.whisper.decode import DecodeResult

    tr, wav = _ladder_backend(tmp_path, seconds=100.0)  # four windows
    backend = tr._backend
    backend.load()
    eot, ts = backend.tokenizer.eot, backend.tokenizer.timestamp_begin
    passes_at = {0: 0.6, 1: 0.0, 2: None, 3: 0.2}  # window -> first passing temperature
    # the rows each retry batch must hold: the failing windows, padded by
    # repeating the last one to the buckets 4, 2, 2, 1, 1
    retry_rows = [[0, 2, 3, 3], [0, 2], [0, 2], [2], [2]]
    batches = []

    # every mel row carries its window index, so the scripted decoder can
    # read which windows it was handed
    monkeypatch.setattr(mod, "log_mel", lambda audio, n_mels: torch.arange(
        audio.shape[0], dtype=torch.float32)[:, None, None].expand(-1, n_mels, 3000))

    def scripted(params, dims, tok, mel, opts, rng=None, audio_kv=None):
        rows = [int(r) for r in mel[:, 0, 0]]
        if opts.temperature > 0:
            assert rows == retry_rows[len(batches) - 1]
            assert opts.beam_size == 1
            assert rng.initial_seed() == 1000 + len(batches) - 1
        batches.append((opts.temperature, len(rows)))
        tokens = np.full((len(rows), 4), eot, np.int32)
        avg = np.zeros(len(rows), np.float32)
        for j, win in enumerate(rows):
            ok = passes_at[win] is not None and opts.temperature >= passes_at[win]
            # the text token names the window and the rung that produced it
            tokens[j, :3] = [ts, 1000 + 10 * win + int(round(opts.temperature * 5)), ts + 50]
            avg[j] = -0.1 if ok else -5.0
        return DecodeResult(tokens, (tokens != eot).sum(-1), avg * 4, avg,
                            np.zeros(len(rows), np.float32))

    monkeypatch.setattr(mod, "decode_windows", scripted)
    out = tr.transcribe(wav)
    assert batches == [(0.0, 4), (0.2, 4), (0.4, 2), (0.6, 2), (0.8, 1), (1.0, 1)]
    # window 0 from rung 0.6 (3), 1 from the beam decode (0), 2 from the
    # last rung (5), 3 from rung 0.2 (1)
    assert [int(s["text"][1:]) for s in out["segments"]] == [1003, 1010, 1025, 1031]
    assert [s["confidence"] for s in out["segments"]] == pytest.approx([-0.1, -0.1, -5.0, -0.1])
    assert backend.last_stats["retried_windows"] == 3


def test_needs_fallback_signature_and_gates_match_jax():
    from modular_audio_pipeline_tpu.transcriber import JaxWhisperBackend
    from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend

    jb = JaxWhisperBackend("test-tiny", weights_path="random:0")
    pb = TorchWhisperBackend("test-tiny", weights_path="random:0", device="cpu")
    assert pb.fallback_temperatures == jb.fallback_temperatures
    loop = "ab" * 200
    for result, text in ((None, "x"), (-0.5, "hello there"), (-1.5, "hello there"),
                         (-0.5, loop)):
        assert pb._needs_fallback(result, None, text) == jb._needs_fallback(result, None, text)
    assert pb._needs_fallback(None, None, "x") and pb._needs_fallback(-0.5, None, loop)
    pb.logprob_threshold = pb.compression_ratio_threshold = None
    assert not pb._needs_fallback(-9.0, None, loop)


def test_random_weights_switch_the_ladder_off():
    from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend

    pb = TorchWhisperBackend("test-tiny", weights_path="random:0", device="cpu")
    assert pb.temperature_fallback
    pb.load()
    assert not pb.temperature_fallback


def test_attach_words_single_window_equals_the_batched_pass(tmp_path):
    """_attach_words (one window at a time) and _attach_words_batch attach
    the same words and refine the same boundaries."""
    import copy

    from modular_audio_pipeline_tpu_torch.models.whisper.decode import (
        decode_windows, encode_audio_kv,
    )
    from modular_audio_pipeline_tpu_torch.ops.mel import log_mel

    tr, _ = _ladder_backend(tmp_path)
    backend = tr._backend
    backend.max_decode_tokens = 16
    backend.load()
    audio = 0.1 * np.random.default_rng(31).standard_normal((2, 480000)).astype(np.float32)
    mel = log_mel(torch.from_numpy(audio), n_mels=backend.dims.n_mels)
    opts = backend._decode_options("en")
    audio_kv = encode_audio_kv(backend.params, backend.dims, mel)
    res = decode_windows(backend.params, backend.dims, backend.tokenizer, mel, opts,
                         audio_kv=audio_kv)
    jobs = []
    for i in range(2):
        segs = backend._parse_window(res.tokens[i], float(res.avg_logprobs[i]), 30.0 * i, 30.0)
        jobs.append((segs, res.tokens[i], i, 30.0 * i))
    assert all(j[0] for j in jobs)
    single = copy.deepcopy(jobs)
    backend._attach_words_batch(jobs, audio_kv, opts)
    for segs, tokens, i, offset in single:
        backend._attach_words(segs, tokens, audio_kv, i, opts, offset)
    assert [j[0] for j in single] == [j[0] for j in jobs]
    assert any("words" in s for j in jobs for s in j[0])


def _words_key(segments):
    return [[(w["word"], w["start"], w["end"]) for w in s.get("words", [])] for s in segments]


@pytest.mark.parametrize("compute", ["float32", "int8"])
def test_proxy_bundle_words_and_int8_segments_equal_jax(eval_sentences, compute):
    """word_timestamps=True (and the int8 decoder) through both transcribers
    on the held-out sentences: segments and words equal. In int8 mode the
    JAX package runs its XLA branch on the CPU (code * bf16(scale) rounded
    to bf16) where the port follows the kernel's arithmetic; on the trained
    bundle no token sits close enough to a tie for that to show, and the
    confidences agree to 2e-2 instead of 5e-4."""
    from modular_audio_pipeline_tpu.transcriber import WhisperTranscriber as JaxTranscriber
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    kw = dict(model_name="tiny", language="en", beam_size=5, weights_path=str(BUNDLE),
              word_timestamps=True, max_decode_tokens=128)
    jax_tr = JaxTranscriber(**kw)
    pt_tr = WhisperTranscriber(**kw, device="cpu")
    if compute == "int8":
        # float32 activations with the quantised decoder: load in float32,
        # then quantise as compute_type="int8" does after loading
        for tr in (jax_tr, pt_tr):
            tr._backend.compute_dtype = "float32"
            tr.load_model()
            tr._backend.compute_dtype = "int8"
            tr._backend._maybe_quantize()
        assert "logits_wq" in pt_tr._backend.params["decoder"]
    else:
        jax_tr._backend.compute_dtype = pt_tr._backend.compute_dtype = "float32"
    for path in eval_sentences:
        want = jax_tr.transcribe(path)
        got = pt_tr.transcribe(path)
        assert got["segments"] and all(s.get("words") for s in got["segments"])
        assert _key(got["segments"]) == _key(want["segments"])
        assert _words_key(got["segments"]) == _words_key(want["segments"])
        np.testing.assert_allclose(
            [s["confidence"] for s in got["segments"]],
            [s["confidence"] for s in want["segments"]], rtol=0,
            atol=5e-4 if compute == "float32" else 2e-2)


def test_int8_compute_type_loads_bf16_and_quantises(tmp_path):
    """compute_type="int8" through from_config: bf16 activations, int8
    codes, f32 scales, on the shipped test-tiny bundle; and it transcribes."""
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    cfg = PipelineConfig()
    cfg.transcription.model = "test-tiny"
    cfg.transcription.compute_type = "int8"
    cfg.transcription.language = "en"
    cfg.transcription.max_decode_tokens = 8
    cfg.transcription.weights_path = str(ROOT / "modular_audio_pipeline_tpu/weights/whisper-test-tiny")
    tr = WhisperTranscriber.from_config(cfg, device="cpu")
    assert tr._backend.compute_dtype == "int8" and tr._backend.word_timestamps
    tr.load_model()
    dec = tr._backend.params["decoder"]
    assert dec["tok_emb"].dtype == torch.bfloat16
    assert dec["blocks"]["cross"]["k_wq"].dtype == torch.int8
    assert dec["blocks"]["cross"]["k_ws"].dtype == torch.float32
    assert dec["logits_ws"].dtype == torch.float32
    assert tr._backend.params["encoder"]["blocks"]["attn"]["q_w"].dtype == torch.bfloat16
    wav = tmp_path / "tone.wav"
    write_wav(str(wav), 0.1 * np.sin(np.arange(16000) / 5.0).astype(np.float32), 16000)
    tr._backend.temperature_fallback = False
    out = tr.transcribe(str(wav))
    assert out["duration"] == 1.0 and isinstance(out["text"], str)

"""The port's BatchDriver and CLI held against the JAX package's on the
CPU.

A directory of three generated WAVs (one of them 44.1 kHz stereo) and one
FLAC runs through both drivers in both modes: ``run()`` (AudioPipeline
per file) and ``run(serving=True)`` (ServingPipeline.run_file per file,
the FLAC converted first). test-tiny's random weights are the JAX
package's, carried across into every port backend the drivers build.
Equal means equal: the ``batch_status.json`` keys and ``success``, the
summaries' counts, and the output JSONs. An interrupted run resumes with
the finished files skipped; ``main(argv, device="cpu")`` returns the JAX
CLI's exit codes. Last, the audio ``chip_smoke.py`` phase 8 makes is held
equal to the audio these tests make with the JAX package's voice model.
"""

import json
import sys
import wave
from math import gcd
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flac_ref import encode_flac
from scipy.signal import resample_poly
from test_pipeline_e2e import fast_config
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.audio_io import write_wav
from modular_audio_pipeline_tpu.parallel.batch import BatchDriver as JaxBatchDriver
from modular_audio_pipeline_tpu.training.voices import sample_voice, synth_utterance
from modular_audio_pipeline_tpu_torch import cli
from modular_audio_pipeline_tpu_torch.config import PipelineConfig
from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
from modular_audio_pipeline_tpu_torch.parallel.batch import BatchDriver
from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend

ROOT = Path(__file__).resolve().parents[1]
SR = 16000
SMOKE_FILES = ("a_meeting.wav", "b_panel_44k_stereo.wav", "c_interview.flac")


def voiced_speech(seconds, seed):
    """Four voices of the JAX package's voice model in turns (phase 8's
    speech, tools/bench_configs.voiced_speech's recipe)."""
    rng = np.random.default_rng(seed)
    voices = [sample_voice(rng) for _ in range(4)]
    n = int(seconds * SR)
    out = np.zeros(n, dtype=np.float32)
    pos = 0
    while pos < n:
        utt = synth_utterance(voices[rng.integers(len(voices))], float(rng.uniform(2.5, 5.0)),
                              rng, pause_prob=0.15)
        take = min(len(utt), n - pos)
        out[pos : pos + take] = utt[:take]
        pos += take + int(rng.uniform(0.08, 0.35) * SR)
    return out


def make_directory(media, seconds, extra_wav=True):
    """Phase 8's three files (16 kHz WAV, 44.1 kHz stereo WAV, FLAC) and,
    for the drivers' tests, a fourth WAV."""
    media.mkdir(parents=True, exist_ok=True)
    write_wav(str(media / SMOKE_FILES[0]), voiced_speech(seconds, 11), SR)
    g = gcd(44100, SR)
    left = resample_poly(voiced_speech(seconds, 12), 44100 // g, SR // g)
    pcm = np.clip(np.round(np.stack([left, 0.8 * left], 1) * 32767.0), -32768, 32767)
    with wave.open(str(media / SMOKE_FILES[1]), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(44100)
        wf.writeframes(pcm.astype("<i2").tobytes())
    pcm = np.clip(np.round(voiced_speech(seconds, 13) * 32767.0), -32768, 32767)
    (media / SMOKE_FILES[2]).write_bytes(encode_flac(pcm.astype(np.int64), SR))
    if extra_wav:
        write_wav(str(media / "d_lecture.wav"), voiced_speech(seconds, 14), SR)
    return media


@pytest.fixture(scope="module")
def jax_params():
    from modular_audio_pipeline_tpu.transcriber import JaxWhisperBackend

    b = JaxWhisperBackend("test-tiny", weights_path="random:0", compute_dtype="float32")
    b.load()
    return jax.tree.map(np.asarray, b.params)


@pytest.fixture
def carried(monkeypatch, jax_params):
    """Every port backend built from here on holds the JAX weights."""
    real = TorchWhisperBackend.load

    def load(self):
        if self.params is None:
            real(self)
            self.params = params_from_numpy(jax_params, self.device, torch.float32)

    monkeypatch.setattr(TorchWhisperBackend, "load", load)


def configs(tmp_path, media):
    jcfg = fast_config(media, **{"transcription.compute_type": "float32",
                                 "transcription.max_decode_tokens": 48,
                                 "diarization.enabled": False})  # paired in test_torch_pipeline
    jcfg.results_dir = str(tmp_path / "jax_results")
    jcfg.temp_dir = str(tmp_path / "jax_temp")
    jcfg.__post_init__()
    data = jcfg.to_dict()
    data.update(results_dir=str(tmp_path / "pt_results"), temp_dir=str(tmp_path / "pt_temp"))
    return jcfg, PipelineConfig.from_dict(data)


def outputs(ledger):
    docs = {}
    for key, entry in ledger.items():
        doc = json.loads(Path(entry["output_file"]).read_text(encoding="utf-8"))
        doc["metadata"]["source_file"] = Path(doc["metadata"]["source_file"]).name
        docs[key] = doc
    return docs


def counts(summary):
    return {k: summary[k] for k in ("total", "succeeded", "failed", "skipped", "audio_seconds")}


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    return make_directory(tmp_path_factory.mktemp("batch") / "media", 4.0)


@pytest.mark.parametrize("serving", [False, True], ids=["audio-pipeline", "serving"])
def test_driver_equals_jax(tmp_path, media, carried, serving):
    jcfg, pcfg = configs(tmp_path, media)
    want = JaxBatchDriver(jcfg).run(serving=serving)
    got = BatchDriver(pcfg, device="cpu").run(serving=serving)
    assert counts(got) == counts(want) and got["succeeded"] == 4
    j_ledger = json.loads((tmp_path / "jax_results" / "batch_status.json").read_text())
    p_ledger = json.loads((tmp_path / "pt_results" / "batch_status.json").read_text())
    assert p_ledger.keys() == j_ledger.keys()
    assert {k: v["success"] for k, v in p_ledger.items()} == {k: v["success"] for k, v in j_ledger.items()}
    assert {k: Path(v["output_file"]).name for k, v in p_ledger.items()} == {
        k: Path(v["output_file"]).name for k, v in j_ledger.items()}
    assert outputs(p_ledger) == outputs(j_ledger)
    assert any(doc["segments"] for doc in outputs(p_ledger).values())


@pytest.mark.parametrize("serving", [False, True], ids=["audio-pipeline", "serving"])
def test_interrupted_run_resumes(tmp_path, media, carried, monkeypatch, serving):
    """A KeyboardInterrupt during the third file: the ledger holds the two
    finished files, and the next run skips them and runs the rest."""
    from modular_audio_pipeline_tpu_torch import pipeline, serving as serving_mod

    _, cfg = configs(tmp_path, media)
    owner, name = ((serving_mod.ServingPipeline, "run_file") if serving
                   else (pipeline.AudioPipeline, "run"))
    real, calls = getattr(owner, name), []

    def interrupt_third(self, *a, **kw):
        calls.append(a)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return real(self, *a, **kw)

    monkeypatch.setattr(owner, name, interrupt_third)
    with pytest.raises(KeyboardInterrupt):
        BatchDriver(cfg, device="cpu").run(serving=serving)
    ledger = json.loads((tmp_path / "pt_results" / "batch_status.json").read_text())
    assert len(ledger) == 2 and all(v["success"] for v in ledger.values())
    monkeypatch.setattr(owner, name, real)
    summary = BatchDriver(cfg, device="cpu").run(serving=serving)
    assert (summary["skipped"], summary["succeeded"], summary["failed"]) == (2, 2, 0)
    after = json.loads((tmp_path / "pt_results" / "batch_status.json").read_text())
    assert len(after) == 4 and all(after[k] == v for k, v in ledger.items())


def test_cli_exit_codes(tmp_path, monkeypatch):
    """The JAX CLI's codes: 1 for an empty directory, a missing --input, an
    invalid config and a mesh larger than the world of ranks (``--devices
    2`` in one process: ``ShardingError``); 130 when interrupted."""
    empty = tmp_path / "empty"
    empty.mkdir()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"vad": {"mode": 9}, "media_dir": str(empty)}))
    base = ["--model", "test-tiny", "--weights-dir", "random:0", "--language", "en"]
    assert cli.main(["--media-dir", str(empty)] + base, device="cpu") == 1
    assert cli.main(["--media-dir", str(empty), "--input", "nope.wav"] + base, device="cpu") == 1
    assert cli.main(["--config", str(bad)] + base, device="cpu") == 1
    assert cli.main(["--media-dir", str(empty), "--batch", "--devices", "2"] + base,
                    device="cpu") == 1

    def interrupted(self, *a, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(BatchDriver, "run", interrupted)
    assert cli.main(["--media-dir", str(empty), "--batch"] + base, device="cpu") == 130


def test_cli_batch_runs_and_resumes(tmp_path, carried):
    """``--batch --serving`` over two WAVs: exit 0, then a rerun skips both."""
    media = tmp_path / "media"
    media.mkdir()
    for i in range(2):
        write_wav(str(media / f"f{i}.wav"), voiced_speech(4.0, 20 + i), SR)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"transcription": {"beam_size": 1, "max_decode_tokens": 48,
                                                    "compute_type": "float32"}}))
    argv = ["--config", str(config), "--media-dir", str(media), "--model", "test-tiny",
            "--weights-dir", "random:0", "--language", "en", "--batch", "--serving"]
    assert cli.main(argv, device="cpu") == 0
    ledger = json.loads((media / "results" / "batch_status.json").read_text())
    assert len(ledger) == 2 and all(v["success"] for v in ledger.values())
    assert cli.main(argv, device="cpu") == 0
    assert json.loads((media / "results" / "batch_status.json").read_text()) == ledger


def test_smoke_phase8_files_equal_the_tests_files(tmp_path):
    """chip_smoke.py phase 8 makes its directory with the port's voice
    model; these tests feed the JAX package the same files, to the byte."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.BATCH_FILES == SMOKE_FILES
    smoke = chip_smoke.batch_directory(tmp_path / "smoke", 6.0)
    ours = make_directory(tmp_path / "tests", 6.0, extra_wav=False)
    assert [p.name for p in smoke] == list(SMOKE_FILES)
    for name in SMOKE_FILES:
        assert (ours / name).read_bytes() == (tmp_path / "smoke" / name).read_bytes(), name

"""The port's ServingPipeline with vocal separation on, held against the
JAX package's end to end on the CPU (test-tiny, random weights carried
across, float32).

A voiced signal under bench config 4's music loop (98, 196.5 and 294 Hz)
goes through ``process`` and ``run_file`` of both packages with
``vocal_separation.enabled`` and ``auto_detect``: with the shipped MaskUNet
bundle (separated on the device over the padded audio, zero tail
restored) and with REPET (an empty weights root: separated on the host
before the upload; the energy VAD and the StatsEmbedder then run too).
Keep intervals, mappings, segments, turns and JSON are equal, as in
tests/test_torch_serving.py; a speech-only file skips separation in both.
"""

import numpy as np
import pytest
from test_serving import make_audio
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from test_torch_serving import assert_equal_results, pair, run_file_and_process

from modular_audio_pipeline_tpu_torch.runtime import tracing

SR = 16000


def music_podcast(seconds: float) -> np.ndarray:
    """The voiced test signal under bench config 4's repeating loop
    (tools/bench_configs.music_podcast's)."""
    speech = make_audio(seconds, seed=4)
    t = np.arange(len(speech)) / SR
    loop = (0.25 * np.sin(2 * np.pi * 98 * t) + 0.15 * np.sin(2 * np.pi * 196.5 * t)
            + 0.1 * np.sin(2 * np.pi * 294 * t))
    return (speech + loop).astype(np.float32)


def separation_on(cfg, auto_detect=True):
    cfg.vocal_separation.enabled = True
    cfg.vocal_separation.auto_detect = auto_detect


@pytest.mark.parametrize("backend", ["masknet", "repet"])
def test_separated_process_and_run_file_equal_jax(backend, tmp_path, monkeypatch):
    from modular_audio_pipeline_tpu.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.models.diarization.embedding import StatsEmbedder

    if backend == "repet":
        monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path / "none"))
    jp, pp = pair(tokens=16, edit=separation_on)
    audio = np.round(music_podcast(40.0) * 0.8 * 32767).astype(np.int16)
    wav = tmp_path / "podcast.wav"
    write_wav(str(wav), audio.astype(np.float32) / 32768.0, SR)  # read back as int16
    out_j, doc_j, want = run_file_and_process(jp, wav, tmp_path / "jax")
    with tracing.record() as rec:
        out_p, doc_p, got = run_file_and_process(pp, wav, tmp_path / "pt")
    assert want["vocal_separation"] is True
    assert want["kept_duration"] > 0 and want["segments"] and want["diarization"]
    assert_equal_results(got, want)
    assert doc_p == doc_j and out_p.segments == out_j.segments
    assert "serving.separation" in rec.summary()
    if backend == "masknet":  # on the device: the host backend is never resolved
        assert type(pp._separation_net).__name__ == "MaskUNet" and pp._separation_fn is None
    else:
        assert pp._separation_fn is not None and pp._separation_net is not None
        assert type(pp._separation_net).__name__ != "MaskUNet"
        assert isinstance(pp._diarizer._embedder, StatsEmbedder)


@pytest.mark.parametrize("case", ["speech_only", "forced", "silent"])
def test_separation_decisions_equal_jax(case, tmp_path, monkeypatch):
    """Speech alone fails the music test and is not separated; with
    ``auto_detect`` off speech is separated all the same (REPET here);
    digital silence has an energy CV of 0, so both packages find "music",
    separate it on the device and take the all-silence early return."""
    if case == "forced":
        monkeypatch.setenv("MAP_TPU_WEIGHTS", str(tmp_path))

    def edit(cfg):
        separation_on(cfg, auto_detect=case != "forced")

    jp, pp = pair(tokens=8, words=False, diarize=False, edit=edit)
    audio = np.zeros(35 * SR, np.float32) if case == "silent" else make_audio(35.0, seed=5)
    want, got = jp.process(audio, SR), pp.process(audio, SR)
    assert want["vocal_separation"] is (case != "speech_only")
    assert (want["kept_duration"] == 0.0) == (case == "silent")
    assert_equal_results(got, want)
    assert (pp._separation_fn is not None) == (case == "forced")

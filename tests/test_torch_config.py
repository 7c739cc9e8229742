"""The port's configuration held against the JAX package's: the same
dataclasses and defaults, ``from_dict``/``from_json`` (``_``-keys are
comments), ``from_env``, ``to_dict``/``to_json``, aggregated ``validate``
errors, the prompt presets, and the CLI's flags and config building.
Everything is host Python, so "equal" means equal."""

import json
import sys
from pathlib import Path

import pytest

from modular_audio_pipeline_tpu import config as jax_config
from modular_audio_pipeline_tpu.exceptions import ConfigurationError as JaxConfigurationError
from modular_audio_pipeline_tpu_torch import cli, config
from modular_audio_pipeline_tpu_torch.exceptions import ConfigurationError

ROOT = Path(__file__).resolve().parents[1]


def test_repo_config_json_loads_equal_in_both_packages():
    got = config.PipelineConfig.from_json(str(ROOT / "config.json"))
    want = jax_config.PipelineConfig.from_json(str(ROOT / "config.json"))
    got.validate()
    want.validate()
    assert got.to_dict() == want.to_dict()
    assert got.transcription.model == "large-v3-turbo" and got.transcription.device == "tpu"
    assert got.tpu.mesh_shape == {} and got.llm.enabled is False


def test_defaults_and_presets_equal():
    assert config.PipelineConfig().to_dict() == jax_config.PipelineConfig().to_dict()
    assert config.get_default_config().to_dict() == jax_config.get_default_config().to_dict()
    assert config.DEFAULT_PROMPTS == jax_config.DEFAULT_PROMPTS
    assert config.PipelineConfig._SCALARS == jax_config.PipelineConfig._SCALARS
    assert list(config.PipelineConfig._NESTED) == list(jax_config.PipelineConfig._NESTED)


BAD = {
    "_comment": "every check of validate() fails once",
    "audio": {"sample_rate": 12345},
    "vad": {"mode": 7, "frame_duration_ms": 25, "start_threshold": 1.5, "stop_threshold": -0.1,
            "_note": "comment keys inside a section are dropped too"},
    "transcription": {"model": "no-such-model"},
    "diarization": {"min_speakers": 6, "max_speakers": 2},
    "redundancy": {"similarity_threshold": 2.0},
    "tpu": {"compute_dtype": "int4", "mesh_shape": {"data": 0}, "bucket_seconds": [30.0, -1.0]},
}


def test_validate_aggregates_the_same_errors(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(BAD))
    with pytest.raises(ConfigurationError) as got:
        config.PipelineConfig.from_json(str(path)).validate()
    with pytest.raises(JaxConfigurationError) as want:
        jax_config.PipelineConfig.from_json(str(path)).validate()
    assert str(got.value) == str(want.value)
    assert got.value.to_dict() == want.value.to_dict()
    assert len(got.value.details.splitlines()) == 10


def test_from_env_equal(monkeypatch, tmp_path):
    monkeypatch.setenv("AUDIO_PIPELINE_MEDIA_DIR", str(tmp_path))
    monkeypatch.setenv("AUDIO_PIPELINE_MODEL", "tiny")
    monkeypatch.setenv("AUDIO_PIPELINE_LANGUAGE", "en")
    monkeypatch.setenv("AUDIO_PIPELINE_PROMPT", "a meeting")
    got, want = config.PipelineConfig.from_env(), jax_config.PipelineConfig.from_env()
    assert got.to_dict() == want.to_dict()
    assert got.media_dir == str(tmp_path) and got.transcription.prompt == "a meeting"


def test_to_json_round_trips_across_packages(tmp_path):
    cfg = config.PipelineConfig(media_dir=str(tmp_path))
    cfg.transcription.model, cfg.vad.provider = "tiny", "webrtc"
    cfg.tpu.profile_dir = str(tmp_path / "trace")
    cfg.to_json(str(tmp_path / "cfg.json"))
    back = jax_config.PipelineConfig.from_json(str(tmp_path / "cfg.json"))
    assert back.to_dict() == cfg.to_dict()
    assert config.PipelineConfig.from_json(str(tmp_path / "cfg.json")).to_dict() == cfg.to_dict()


def _jax_cli():
    sys.path.insert(0, str(ROOT))
    import main as jax_main

    return jax_main


def test_cli_has_the_jax_clis_flags():
    def flags(parser):
        return sorted((a.dest, tuple(a.option_strings), a.default, tuple(a.choices or ()))
                      for a in parser._actions)

    seen = {}

    def capture(real):
        def parse(self, args=None, namespace=None):
            seen.setdefault("parser", []).append(self)
            return real(self, args, namespace)
        return parse

    import argparse

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture(real)
    try:
        cli.parse_args([])
        _jax_cli().parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = real
    port, jax_parser = seen["parser"]
    assert flags(port) == flags(jax_parser)


@pytest.mark.parametrize("argv", [
    [],
    ["--media-dir", "{tmp}", "--model", "tiny", "--language", "en", "--prompt-preset",
     "en_general", "--weights-dir", "random:0", "--batch-size", "4", "--patience", "2",
     "--separate-vocals", "--auto-separate", "--no-diarization", "--no-vad",
     "--no-noise-reduction", "--min-speakers", "2", "--max-speakers", "3",
     "--output-dir", "{tmp}/out", "--profile-dir", "{tmp}/trace"],
    ["--config", "{root}/config.json", "--media-dir", "{tmp}", "--prompt", "hello"],
    ["--devices", "2", "--tp", "2"],
])
def test_build_config_equal_jax(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [a.format(tmp=tmp_path, root=ROOT) for a in argv]
    jax_main = _jax_cli()
    got = cli.build_config(cli.parse_args(argv))
    want = jax_main.build_config(jax_main.parse_args(argv))
    assert got.to_dict() == want.to_dict()

"""The port's LLM post-processing and the paths that now reach it, held
against the JAX package on the CPU.

The heuristic analyzer and ``validate_analysis`` are host code: equal
results on seeded random transcripts and dicts. The OpenAI tier needs the
network and the ``openai`` package; without the package both packages
refuse it the same way (no test calls the network). Then ``AudioPipeline``
with ``llm.enabled`` (the JSON with its ``llm_analysis``) and with
``chunking="sequential"``, and the CLI with a sequential config: output
JSON equal to the JAX package's, test-tiny's random weights carried
across, float32.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
from test_pipeline_e2e import make_speechy_wav
from test_torch_batch import carried, jax_params  # noqa: F401  (fixtures)
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from test_torch_pipeline import pair, run_both

from modular_audio_pipeline_tpu import post_processing as jax_pp
from modular_audio_pipeline_tpu import post_processing_hybrid as jax_hybrid
from modular_audio_pipeline_tpu_torch import post_processing as pt_pp
from modular_audio_pipeline_tpu_torch import post_processing_hybrid as pt_hybrid

ROOT = Path(__file__).resolve().parents[1]
SENTENCES = [
    "We will ship the release on Friday.", "The bug in the parser is a problem.",
    "Alice agreed to review the plan", "Bob needs to follow up with the vendor!",
    "Great progress on the dashboard.", "Is the risk of delay resolved?",
    "Vamos revisar o contrato amanhã.", "O atraso é um risco.", "ok", "Let's take care of it.",
    "Our success depends on the migration.", "Carol said the meeting went well.",
]


def random_transcript(rng):
    n = int(rng.integers(0, 14))
    parts = [str(s) for s in rng.choice(SENTENCES, size=n)]
    sep = str(rng.choice([" ", "\n", "  "]))
    return sep.join(parts)


@pytest.mark.parametrize("seed", range(8))
def test_heuristic_analyzer_equals_jax(seed):
    rng = np.random.default_rng(seed)
    text = random_transcript(rng)
    kw = dict(max_summary_sentences=int(rng.integers(1, 5)), max_topics=int(rng.integers(1, 8)))
    assert pt_hybrid.HeuristicAnalyzer(**kw).process(text) == \
        jax_hybrid.HeuristicAnalyzer(**kw).process(text)


@pytest.mark.parametrize("data", [
    {},
    {"summary": "s", "topics": ["a", 2], "sentiment": "POSITIVE"},
    {"summary": 3, "topics": None, "action_items": ["do it", {"description": "x", "owner": "A",
                                                                 "due": "Fri"},
                                                   {"owner": "nobody"}, 7],
     "sentiment": "angry"},
    {"action_items": None, "sentiment": "Mixed"},
])
def test_validate_analysis_equals_jax(data):
    got, want = pt_pp.validate_analysis(data), jax_pp.validate_analysis(data)
    assert got.to_dict() == want.to_dict()
    assert type(got).__name__ == "MeetingAnalysis"


def test_schemas_equal_jax():
    item = pt_pp.ActionItem("x", owner="A")
    assert pt_pp.MeetingAnalysis("s", action_items=[item]).to_dict() == \
        jax_pp.MeetingAnalysis("s", action_items=[jax_pp.ActionItem("x", owner="A")]).to_dict()


def test_openai_surface_without_the_package(monkeypatch):
    """No ``openai`` package: LLMPostProcessor raises ImportError as the JAX
    one does, and the ladder with a key set falls through to the
    heuristic in both packages."""
    monkeypatch.setitem(sys.modules, "openai", None)  # an import of it fails
    for mod in (pt_pp, jax_pp):
        with pytest.raises(ImportError, match="OpenAI backend unavailable"):
            mod.LLMPostProcessor()
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test-not-used")
    got, want = pt_hybrid.HybridLLMPostProcessor(), jax_hybrid.HybridLLMPostProcessor()
    assert got.get_backend_info() == want.get_backend_info() == {
        "backend": "heuristic", "model": "extractive-heuristic"}
    text = " ".join(SENTENCES)
    assert got.process(text) == want.process(text)


def test_openai_tier_reply_is_validated(monkeypatch):
    """With a client in place (a stand-in: no network), the OpenAI tier's
    JSON reply goes through validate_analysis, and a failed call is an
    error dict, as in the JAX package."""
    class Client:
        def __init__(self, reply):
            create = (lambda **kw: (_ for _ in ()).throw(RuntimeError("down"))) \
                if reply is None else (lambda **kw: Reply(reply))
            self.chat = type("Chat", (), {"completions": type("C", (), {"create": staticmethod(create)})})

    class Reply:
        def __init__(self, content):
            msg = type("M", (), {"content": content})
            self.choices = [type("Ch", (), {"message": msg})]

    for reply in ('{"summary": "s", "sentiment": "negative", "action_items": ["x"]}', None):
        got, want = object.__new__(pt_pp.LLMPostProcessor), object.__new__(jax_pp.LLMPostProcessor)
        for proc in (got, want):
            proc.model, proc.temperature, proc._client = "m", 0.0, Client(reply)
        assert got.process("text") == want.process("text")


def test_audio_pipeline_llm_analysis_equals_jax(tmp_path, monkeypatch):
    """AudioPipeline with llm.enabled (no OpenAI key, no local model: the
    heuristic tier): the JSON, with its llm_analysis, equals the JAX
    package's, and the stage is timed as "llm"."""
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    jp, pp = pair(tmp_path, lambda d: make_speechy_wav(str(d / "recording.wav"), 35.0),
                  **{"llm.enabled": True})
    assert pp.llm_processor.get_backend_info()["backend"] == "heuristic"
    out, doc, _ = run_both(jp, pp)
    assert doc["segments"] and "llm_analysis" in doc
    assert out.llm_analysis == doc["llm_analysis"]
    assert "llm" in out.metadata["stage_timings"] and out.metadata["llm_enabled"]


def test_audio_pipeline_without_llm_writes_no_analysis(tmp_path):
    _, pp = pair(tmp_path, lambda d: make_speechy_wav(str(d / "recording.wav"), 8.0),
                 carry=False)
    assert pp.llm_processor is None


@pytest.mark.parametrize("backend", ["faster-whisper", "openai"])
def test_audio_pipeline_sequential_equals_jax(tmp_path, backend):
    """chunking="sequential" through AudioPipeline (both transcription
    backends; the device buffer takes the seek loop's host path): equal
    JSON, mappings and segments."""
    jp, pp = pair(tmp_path, lambda d: make_speechy_wav(str(d / "recording.wav"), 35.0),
                  **{"transcription.chunking": "sequential", "transcription.backend": backend,
                     "transcription.max_decode_tokens": 48})
    assert pp.transcriber._backend.chunking == "sequential"
    _, doc, _ = run_both(jp, pp)
    assert doc["segments"]


def test_cli_sequential_equals_jax(tmp_path, carried):  # noqa: F811
    """``python -m modular_audio_pipeline_tpu_torch`` with a config that sets
    chunking="sequential" and llm.enabled, against the repository's
    main.py on the same file: exit 0 and equal output JSON."""
    sys.path.insert(0, str(ROOT))
    import main as jax_main

    from modular_audio_pipeline_tpu_torch import cli

    docs = []
    for name, run in (("jax", lambda argv: jax_main.main(argv)),
                      ("pt", lambda argv: cli.main(argv, device="cpu"))):
        media = tmp_path / name
        media.mkdir()
        make_speechy_wav(str(media / "talk.wav"), 35.0)
        config = tmp_path / f"{name}.json"
        config.write_text(json.dumps({
            "transcription": {"chunking": "sequential", "beam_size": 1, "max_decode_tokens": 48,
                              "compute_type": "float32"},
            "diarization": {"enabled": False},
            "llm": {"enabled": True, "use_openai": False}}))
        argv = ["--config", str(config), "--media-dir", str(media), "--input",
                str(media / "talk.wav"), "--model", "test-tiny", "--weights-dir", "random:0",
                "--language", "en"]
        assert run(argv) == 0
        doc = json.loads((media / "results" / "talk_transcription.json").read_text())
        doc["metadata"]["source_file"] = Path(doc["metadata"]["source_file"]).name
        docs.append(doc)
    assert docs[1] == docs[0]
    assert docs[1]["segments"] and "llm_analysis" in docs[1]

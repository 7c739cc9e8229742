"""``evaluation.crossfade`` held against the JAX package's
``tools/eval_crossfade.py`` on the CPU: one stream of half a minute,
stripped with 20 ms crossfades and with hard cuts, gives the tool's
hypotheses and its JSON. The tool runs in a subprocess beside the port;
both ladders are bound to one greedy decode (samples differ across
packages by design), and the windows sent up the ladder must be equal.
"""

from jax_eval_tool import paired_run
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu_torch.evaluation import crossfade


def test_crossfade_equals_jax(monkeypatch):
    got, calls, retried, want = paired_run(
        monkeypatch, crossfade, "eval_crossfade", ["--minutes", "0.5", "--streams", "1"],
        lambda: crossfade.evaluate(minutes=0.5, streams=1, device="cpu"))
    assert calls == want["wer_calls"] and len(calls) == 2  # crossfaded, then hard-cut
    assert retried == want["retried"]
    assert got == want["out"]

"""``evaluation.longform`` held against the JAX package's
``tools/eval_longform.py`` on the CPU: one stream of half a minute through
the batched windows and the seek loop gives the tool's hypotheses, WERs,
word counts and monotonicity. The tool runs in a subprocess beside the
port; both ladders are bound to one greedy decode (samples differ across
packages by design), and the windows sent up the ladder must be equal.
"""

from jax_eval_tool import paired_run
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu_torch.evaluation import longform


def test_longform_equals_jax(monkeypatch):
    got, calls, retried, want = paired_run(
        monkeypatch, longform, "eval_longform", ["--minutes", "0.5", "--streams", "1"],
        lambda: longform.evaluate(minutes=0.5, streams=1, device="cpu"))
    assert calls == want["wer_calls"] and len(calls) == 2  # one stream through each path
    assert retried == want["retried"]
    for mode in ("batched", "sequential"):
        keys = ("wer", "ref_words", "monotonic")
        assert {k: got[mode][k] for k in keys} == {k: want["out"][mode][k] for k in keys}
        assert got[mode]["monotonic"] and got[mode]["segments"] > 0

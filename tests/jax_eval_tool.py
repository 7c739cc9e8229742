"""Run one of the JAX package's decode-quality tools for a paired test.

    python tests/jax_eval_tool.py eval_longform --minutes 0.5 --streams 1

runs ``tools/<tool>.py``'s ``main`` on the CPU with every ``wer`` call
recorded and each rung of the temperature ladder bound to one greedy
decode (samples cannot be equal across packages: another generator), and
prints one JSON line: ``{"out": <the tool's JSON>, "wer_calls": [[ref,
hyp], ...], "retried": [[window, ...], ...]}``, with the JAX native
library loaded as ``torch_jax_native`` loads it. :func:`paired_run` runs
it beside the port's harness, whose ladder :func:`greedy_rungs` binds too.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def greedy_rungs(decode_windows, retried: list):
    """A ``_retry_windows`` that records the windows sent up the ladder and
    answers them with one greedy decode."""
    def retry(self, mel, failing, opts):
        retried.append(list(failing))
        res = decode_windows(self.params, self.dims, self.tokenizer, mel, replace(opts, beam_size=1))
        return {i: (res.tokens[i], float(res.avg_logprobs[i])) for i in failing}
    return retry


@contextlib.contextmanager
def two_torch_threads():
    """Two intra-op threads for the port's decode beside the JAX side (the
    suite's workers hold one each, ``one_torch_thread``; the tool runs XLA
    on one), restored afterwards."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def paired_run(monkeypatch, module, tool: str, argv: list, run) -> tuple:
    """``tools/<tool>.py`` in a subprocess (this script) while ``run()``
    drives the port's harness ``module`` with its ``wer`` calls recorded and
    its ladder bound to the same greedy decode -> (the port's result, its
    calls, its retried windows, the tool's document)."""
    from modular_audio_pipeline_tpu_torch.models.whisper import decode
    from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend

    proc = subprocess.Popen([sys.executable, __file__, tool, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        calls, retried = [], []
        real = module.wer

        def spy(ref, hyp):
            calls.append([ref, hyp])
            return real(ref, hyp)

        monkeypatch.setattr(module, "wer", spy)
        monkeypatch.setattr(TorchWhisperBackend, "_retry_windows",
                            greedy_rungs(decode.decode_windows, retried))
        with two_torch_threads():
            got = run()
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    return got, calls, retried, json.loads(out.strip().splitlines()[-1])


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # the tool's time is XLA's compiles, not its arithmetic: one thread for
    # it leaves the cores to the port's decode, which runs beside it
    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    sys.path.insert(0, str(ROOT))
    import importlib

    import modular_audio_pipeline_tpu.evaluation.metrics as metrics
    from modular_audio_pipeline_tpu.models.whisper import decode
    from modular_audio_pipeline_tpu.transcriber import JaxWhisperBackend

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_jax_native import load_jax_native

    load_jax_native()  # the native crossfade, not numpy's, as in the test process
    tool = importlib.import_module(f"tools.{sys.argv[1]}")
    calls, retried = [], []
    real_wer = metrics.wer

    def wer(ref, hyp):
        calls.append([ref, hyp])
        return real_wer(ref, hyp)

    metrics.wer = wer
    JaxWhisperBackend._retry_windows = greedy_rungs(decode.decode_windows, retried)
    sys.argv = [tool.__file__, *sys.argv[2:]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tool.main()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps({"out": out, "wer_calls": calls, "retried": retried}))


if __name__ == "__main__":
    main()

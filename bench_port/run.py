"""The port's benchmark: one cell, one run.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of ``BENCHMARK.json`` named ``--workload`` on this machine's
card: set-up (weights made on the card from the configuration's seed,
inputs from ``--seed``, the cell's shapes warmed), a window of
``--seconds``, then the check of what the window produced against the
plain reference (``reference/``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
read by ``metrics/<name>.py``), ``device`` and, traced, ``breakdown``;
its last key, ``checks``, holds each number compared beside its limit,
which are also the last lines of standard error. The line before it
holds the run's work counts. Exits non-zero with no result without a
CUDA card, and when the process holds a module of the JAX stack or of the
JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def environment() -> None:
    """Caches and bundles inside the checkout: the port's kernels build into
    its own ``_build/`` there; the VAD and diarization bundles are read
    from the checkout's shipped weights, never from the user's cache. One
    host thread for operators: with four, a serving window read 324-351
    audio_s/s over three runs, with one 356-364 (measured on one H100)."""
    os.environ["MAP_TPU_WEIGHTS"] = str(ROOT / "modular_audio_pipeline_tpu" / "weights")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.setdefault("USE_FLAX", "0")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def per_layer(cell, ctx):
    from bench_port.spec import reader

    out = {}
    for m in cell["per_layer"]:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(out, checks) -> bool:
    """``correct``: no request or step failed, some were attempted, and
    every number compared lies within its limit."""
    return bool(out["failed"] == 0 and out["attempted"] > 0
                and all(c["value"] <= c["limit"] for c in checks))


def execute(cell, seed: int, seconds: float, traced: bool, device: str, t_start: float,
            faults=None, control: bool = False):
    """Runs the cell with the module of its traffic's kind
    (``kinds/<kind>.py``, found by name); returns (result dict, the kind's
    output)."""
    from bench_port.spec import kind

    out = kind(cell["traffic"]["kind"]).run(cell, seed, seconds, traced, device, t_start,
                                            faults=faults, control=control)
    correct = verdict(out, out["checks"])
    if traced:
        metrics = per_layer(cell, out["ctx"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics}
    return result, out


def main(argv=None) -> int:
    args = parse_args(argv)
    environment()
    import torch

    from bench_port import spec

    cell = spec.cell(args.workload, spec.benchmark())
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = power_limit()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)
    torch.set_num_threads(1)

    result, out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = spec.forbidden_modules()
    if found:
        print(f"refused: the process holds {found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        tr = out.get("trace")
        result["device"]["busy_s"] = tr.busy_s() if tr else 0.0
        result["device"]["window_s"] = tr.window_s if tr else 0.0
        if tr:
            result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in out["checks"]}
    for e in out.get("errors", []):
        print(f"error: {e}", file=sys.stderr)
    print(f"setup_s {out['setup_s']:.3f}, window {out['ctx']['window_s']:.3f} s, "
          f"timings {json.dumps(out.get('timings', {}))}", file=sys.stderr)
    print(f"power.limit beside the rooflines and MFU: {card}", file=sys.stderr)
    print("work: " + json.dumps({"seed": args.seed, "requests": out["work"]}))
    for c in out["checks"]:
        extra = {k: v for k, v in c.items() if k not in ("name", "value", "limit")}
        print(f"check {c['name']}: {c['value']} (limit {c['limit']}) {json.dumps(extra)}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings the limits of ``limits/<workload>.json`` are set from.

    python3 bench_port/control.py --workload <name> --seconds <s> --seeds 1 2 3 ...
    python3 bench_port/control.py --workload <name> --seconds <s> --seeds 1 --faults a b

Runs the cell once per seed, each a whole run (set-up, a window of
``--seconds`` at the cell's own load, the check), and prints one JSON line
per run. Without ``--faults``: the program's numbers with its verdict, and
the control's, judged by the same check with the control's outputs in the
program's place (the reference one step below the configured precision:
fp8 products for a bf16 serving configuration, TF32 for an f32 training
one with TF32 off; for training also the reference with the loss over
half of each batch). With ``--faults``: one run per fault and seed, the
fault (``faults.py``) planted in the program. Exits 1 when the program is
not correct without a fault, or when the control or a fault is. The
benchmark's own runs never compute these readings. Large-v3 serving
takes one seed a process: its window peaks at 66 GiB, and a second seed in
the same process ran out of memory with 51 GiB still allocated (measured
on one H100).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(HERE.parent)


def readings(checks):
    """Each number compared, with what its check records beside it."""
    return {c["name"]: {k: v for k, v in c.items() if k != "name"} for c in checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Control and fault readings of one cell over seeds.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from bench_port import faults, run, spec

    run.environment()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {run.power_limit()}", file=sys.stderr)
    cell = spec.cell(args.workload, spec.benchmark())
    kind = cell["traffic"]["kind"]
    status = 0
    for fault in args.faults or [None]:
        for seed in args.seeds:
            t0 = time.perf_counter()
            planted = faults.plant(kind, fault) if fault else None
            result, out = run.execute(cell, seed, args.seconds, False, args.device, t0,
                                      faults=planted, control=fault is None)
            line = {"seed": seed, "fault": fault, "correct": result["correct"],
                    "checks": readings(out["checks"]),
                    "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                    "errors": out["errors"]}
            if fault is None:
                line["control_correct"] = run.verdict(out, out.get("control_checks", []))
                line["control"] = readings(out.get("control_checks", []))
                for name, checks in out.get("fault_checks", {}).items():
                    line[f"{name}_correct"] = run.verdict(out, checks)
                    line[name] = readings(checks)
                bad = (not result["correct"] or line["control_correct"]
                       or any(line[f"{n}_correct"] for n in out.get("fault_checks", {})))
            else:
                bad = result["correct"]
            status = status or int(bad)
            del out
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            print(json.dumps(line, default=str), flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())

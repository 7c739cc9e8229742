"""Finds a cell's configuration, traffic, traffic kind, limits and
per-layer readers by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (the file the entry names),
``traffic/<traffic>.json``, ``kinds/<kind>.py`` (the ``kind`` that the
traffic file names), ``limits/<workload>.json`` and
``metrics/<metric>.py``. A later change adds a cell, a traffic mix, a
traffic kind or a metric as new files and entries, and edits none of
these."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "modular_audio_pipeline_tpu")


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: Dict[str, Any], root: Path = ROOT) -> Dict[str, Any]:
    """The workload ``name`` with its configuration, traffic and metrics
    (``end_to_end`` and ``per_layer`` entries that apply to it)."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": w,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "limits": json.loads((HERE / "limits" / f"{name}.json").read_text()),
    }


def kind(name: str):
    """The module ``kinds/<name>.py``: its ``run(cell, seed, seconds,
    traced, device, t_start, faults=None, control=False)`` runs a cell of
    that kind and returns its output (``attempted``, ``failed``,
    ``checks``, ``e2e``, ``setup_s``, ``ctx``, ...)."""
    return importlib.import_module(f"bench_port.kinds.{name}")


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (the port's name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))

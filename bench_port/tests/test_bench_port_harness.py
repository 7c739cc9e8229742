"""CPU tests of the port's benchmark harness (``bench_port/``).

    python -m pytest bench_port/tests -q

They run the harness's own code paths at ``tiny.py``'s size on the CPU,
where the port's kernels take their plain versions. Tests that need the
card take the ``cuda`` fixture and skip without one; on the card's machine
run them with ``python -m pytest --noconftest bench_port/tests -q``.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from tiny import ROOT, cell as tiny_cell  # noqa: I001

from bench_port import faults, roofline, run, spec, synth

HERE = ROOT / "bench_port"


@pytest.fixture(autouse=True)
def _shipped_bundles(monkeypatch):
    monkeypatch.setenv("MAP_TPU_WEIGHTS", str(ROOT / "modular_audio_pipeline_tpu" / "weights"))
    torch.set_num_threads(4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return "cuda"


def test_every_name_in_benchmark_json_has_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert callable(spec.kind(c["traffic"]["kind"]).run), w["name"]
        assert c["limits"], w["name"]
        assert c["end_to_end"] and c["per_layer"], w["name"]
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench_port/configs/")


def test_configs_hold_the_port_models_widths():
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS

    for c in spec.benchmark()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        dims = WHISPER_DIMS[cfg["port_model"]]
        assert (cfg["d_model"], cfg["encoder_layers"], cfg["decoder_layers"],
                cfg["encoder_attention_heads"], cfg["num_mel_bins"], cfg["vocab_size"],
                cfg["max_target_positions"]) == (
            dims.n_audio_state, dims.n_audio_layer, dims.n_text_layer, dims.n_audio_head,
            dims.n_mels, dims.n_vocab, dims.n_text_ctx)
        assert cfg["encoder_ffn_dim"] == cfg["decoder_ffn_dim"] == 4 * cfg["d_model"]
        assert cfg["reduced"] == []


def test_special_tokens_are_the_tokenizers():
    from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer

    for cfg in [json.loads((ROOT / c["file"]).read_text())
                for c in spec.benchmark()["configs"]] + [tiny_cell("turbo.talk_32min")["config"]]:
        tok = load_tokenizer(None, n_vocab=cfg["vocab_size"])
        st = cfg["special_tokens"]
        assert tok.sot_sequence("en", "transcribe", True) == st["sot_sequence"]
        assert (tok.eot, tok.no_timestamps, tok.timestamp_begin, tok.no_speech) == (
            st["eot"], st["no_timestamps"], st["timestamp_begin"], st["no_speech"])


def test_talk_layout_is_the_same_for_every_seed():
    """The layout comes from the traffic file alone; at a short duration
    the program keeps the same windows for seeds 0-3 and kept seconds
    inside one window band."""
    from bench_port import weights
    from bench_port.kinds import serve_closed_loop as serve

    c = tiny_cell("turbo.talk_32min", seconds=120.0, windows=4)
    c["traffic"]["stages"]["diarization"] = False
    c["traffic"]["decode"].update({"max_tokens": 2, "word_timestamps": False})
    g = c["traffic"]["generator"]
    lays = [synth.recordings(dict(c["traffic"], generator=dict(g, pool=1)), s)[1]
            for s in range(4)]
    assert all(lay == lays[0] for lay in lays)
    tree = weights.make_weights(c["config"], torch.bfloat16, "cpu")
    pipe = serve.build_pipeline(c["config"], c["traffic"], tree, "cpu")
    kept = []
    for s in range(4):
        pool, _ = synth.recordings(dict(c["traffic"], generator=dict(g, pool=1)), s)
        r = pipe.process(pool[0], 16000)
        kept.append((r["kept_duration"], r["decode_stats"]["n_windows"]))
    assert len({w for _, w in kept}) == 1, kept
    assert max(k for k, _ in kept) - min(k for k, _ in kept) < 10.0, kept


def test_nothing_the_harness_runs_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import time, json\n"
        "from tiny import cell\n"
        "from bench_port import run, spec\n"
        "run.environment()\n"
        "for w in ('turbo.talk_32min', 'turbo.finetune_b8'):\n"
        "    c = cell(w)\n"
        "    run.execute(c, 5, 0.5, True, 'cpu', time.perf_counter())\n"
        "print(json.dumps(spec.forbidden_modules()))\n" % (str(ROOT), str(HERE / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "modular_audio_pipeline_tpu",
                                               "modular_audio_pipeline_tpu_torch"), (path, n)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.reference.whisper, bench_port.reference.train\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('modular_audio')"
            " or m.split('.')[0] in ('jax', 'flax')))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_roofline_reproduces_the_kernel_table():
    t, what = roofline.flash_bound_s((16, 20, 1500, 64), "bfloat16")
    assert what == "operations" and abs(t * 1e3 - 0.186) < 0.001
    t, what = roofline.flash_bound_s((8, 20, 1500, 64), "float32")
    assert what == "operations" and abs(t * 1e3 - 1.376) < 0.001
    # row 2: BW 16, K 5, H 20, ctx 448, hd 64, int8, random ancestry, the
    # bucket's last step (every position live)
    g = torch.Generator().manual_seed(0)
    anc = torch.randint(0, 5, (16, 5, 448), generator=g)
    anc[:, :, -1] = torch.arange(5)
    selected = sum(len(set(r.tolist())) for r in anc.permute(0, 2, 1).reshape(-1, 5))
    n = roofline.ancestry_bytes((80, 20, 1, 64), 2, selected, 64, 1, True, anc.numel(), 448)
    assert abs(roofline.ancestry_bound_s(n) * 1e3 - 0.0198) < 0.0006


def _execute(workload, faults=None, seconds=0.5):
    c = tiny_cell(workload)
    result, out = run.execute(c, 20260101, seconds, False, "cpu", time.perf_counter(),
                              faults=faults)
    return result, {x["name"]: x for x in out["checks"]}


def test_a_sound_serving_run_is_correct():
    result, checks = _execute("turbo.talk_32min")
    assert result["correct"], checks
    assert checks["logprob_gap"]["windows"] == 3


@pytest.mark.parametrize("kind", sorted(faults.SERVE))
def test_a_broken_serving_path_is_not_correct(kind):
    result, checks = _execute("turbo.talk_32min", faults=faults.SERVE[kind])
    assert not result["correct"], checks


def test_a_sound_training_run_is_correct():
    result, checks = _execute("turbo.finetune_b8")
    assert result["correct"], checks


@pytest.mark.parametrize("kind", sorted(faults.TRAIN))
def test_a_broken_training_step_is_not_correct(kind):
    result, checks = _execute("turbo.finetune_b8", faults=faults.TRAIN[kind])
    assert not result["correct"], checks


def test_the_control_in_the_programs_place_is_not_correct():
    """The control goes through the cell's own check with its outputs in
    the program's place, and comes out not correct, while the program on
    the same run does (tiny serving and training cells on the CPU; the
    CPU has no TF32, so there the training control reads as the reference
    and only the reference's half-batch fault is judged)."""
    for workload in ("turbo.talk_32min", "turbo.finetune_b8"):
        result, out = run.execute(tiny_cell(workload), 20260102, 0.5, False, "cpu",
                                  time.perf_counter(), control=True)
        assert result["correct"], out["checks"]
        if workload == "turbo.talk_32min":
            assert not run.verdict(out, out["control_checks"]), out["control_checks"]
        for name, checks in out.get("fault_checks", {}).items():
            assert not run.verdict(out, checks), (name, checks)


@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_control_fails_the_cells_limits(cuda, workload):
    """At the cell's own size, in a process of its own (``control.py``, as
    the readings were taken): the control in the program's place is not
    correct by the cell's own check, and the program is."""
    out = subprocess.run([sys.executable, str(HERE / "control.py"), "--workload", workload,
                          "--seconds", "1", "--seeds", "31337"],
                         capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:] + out.stdout[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and not line["control_correct"], line

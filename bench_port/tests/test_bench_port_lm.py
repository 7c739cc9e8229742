"""CPU tests of the LM cell's harness (``kinds/lm_analysis.py``,
``lm_weights.py``, ``roofline_lm.py``, ``reference/deepseek_v2.py``).

    python -m pytest bench_port/tests -q

They run the cell at the port's ``test-small`` DeepSeek-V2 configuration
(its widths under the published keys, short prompts and answers) on the
CPU; the traffic kind, the checks and the cell's limits are the cell's
own. The card's run of the same check is ``control.py`` (the harness
tests' ``test_the_control_fails_the_cells_limits``).
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import pytest
import torch

from tiny import ROOT  # noqa: I001

from bench_port import faults, roofline_lm, run, spec
from bench_port.kinds import lm_analysis
from bench_port.lm_weights import make_weights, param_count

from modular_audio_pipeline_tpu_torch.models.lm import deepseek_v2 as ds

WORKLOAD = "dsv2lite.notes_16k"


def published(c: ds.DeepseekV2Config) -> dict:
    """A port configuration under the published ``config.json`` keys."""
    return {
        "num_hidden_layers": c.n_layers, "hidden_size": c.d_model,
        "num_attention_heads": c.n_heads, "num_key_value_heads": c.n_heads,
        "qk_nope_head_dim": c.qk_nope_dim, "qk_rope_head_dim": c.qk_rope_dim,
        "v_head_dim": c.v_head_dim, "kv_lora_rank": c.kv_lora_rank, "q_lora_rank": None,
        "intermediate_size": c.d_ff, "moe_intermediate_size": c.moe_d_ff,
        "n_routed_experts": c.n_experts, "num_experts_per_tok": c.top_k,
        "n_shared_experts": c.n_shared, "first_k_dense_replace": c.first_k_dense,
        "vocab_size": c.vocab_size, "max_position_embeddings": c.max_seq,
        "rope_theta": c.rope_theta, "rms_norm_eps": c.rms_eps,
        "routed_scaling_factor": c.routed_scaling, "norm_topk_prob": c.norm_topk_prob,
        "bos_token_id": c.bos_id, "eos_token_id": c.eos_id,
        "rope_scaling": {"beta_fast": c.beta_fast, "beta_slow": c.beta_slow,
                         "factor": c.rope_factor, "mscale": c.mscale,
                         "mscale_all_dim": c.mscale_all_dim,
                         "original_max_position_embeddings": c.rope_original_max,
                         "type": "yarn"},
    }


def tiny_cell() -> dict:
    c = copy.deepcopy(spec.cell(WORKLOAD, spec.benchmark()))
    c["config"].update(published(ds.DEEPSEEK_V2_CONFIGS["test-small"]))
    c["config"]["port_model"] = "test-small"
    c["traffic"]["generator"].update({"prompt_tokens": 48, "pool": 2, "id_range": [0, 500],
                                      "answer_tokens": 6})
    return c


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)


def test_the_configuration_is_the_ports_deepseek_v2_lite():
    cfg = spec.cell(WORKLOAD, spec.benchmark())["config"]
    want = published(ds.DEEPSEEK_V2_CONFIGS[cfg["port_model"]])
    assert {k: cfg[k] for k in want} == want
    assert cfg["reduced"] == [] and cfg["q_lora_rank"] is None
    assert (cfg["scoring_func"], cfg["topk_method"], cfg["n_group"], cfg["topk_group"]) == (
        "softmax", "greedy", 1, 1)
    assert cfg["tie_word_embeddings"] is False and cfg["hidden_act"] == "silu"
    # 15.7B parameters, 31.4 GB in bf16
    assert abs(param_count(cfg) / 1e9 - 15.7) < 0.05


def test_the_weights_have_the_ports_layout():
    cfg = tiny_cell()["config"]
    tree = make_weights(cfg, torch.float32, "cpu")
    want = ds.init_params(ds.DEEPSEEK_V2_CONFIGS["test-small"], torch.Generator().manual_seed(0))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in t.items()}

    assert shapes(tree) == shapes(want)
    assert torch.equal(tree["blocks"]["attn_norm"], torch.ones_like(tree["blocks"]["attn_norm"]))
    w = tree["moe"]["w_down"]
    assert abs(float(w.std()) * cfg["moe_intermediate_size"] ** 0.5 - 1.0) < 0.1
    # leaves start a multiple of 64 elements into the one buffer
    assert (w.data_ptr() - tree["tok_emb"].data_ptr()) % (64 * w.element_size()) == 0


def test_the_arithmetic_of_the_published_configuration():
    """Active parameters a token (2.45B with the head); a decode step at
    16.5k of context: 4.9 GB of weights and 0.51 GB of latent cache in
    bf16; a request: the prefill's 7.3e13 FLOPs of products and 3.7e13 of
    causal attention, and 127 steps of about 5e9."""
    cfg = spec.cell(WORKLOAD, spec.benchmark())["config"]
    body = roofline_lm.body_params(cfg)
    assert abs((body + 2048 * 102400) / 1e9 - 2.45) < 0.01
    cache = 27 * 16512 * 576 * 2
    assert abs(cache / 1e9 - 0.51) < 0.01
    step = roofline_lm.decode_step_bytes(cfg, 16511)
    assert abs((step - cache) / 1e9 - 4.9) < 0.2
    flops = roofline_lm.request_flops(cfg, 16384, 128)
    assert abs(flops / 1e14 - 1.1) < 0.02


def _execute(fault=None, control=False, traced=False):
    result, out = run.execute(tiny_cell(), 20260101, 0.3, traced, "cpu", time.perf_counter(),
                              faults=faults.plant("lm_analysis", fault) if fault else None,
                              control=control)
    return result, out, {x["name"]: x for x in out["checks"]}


def test_a_sound_lm_run_is_correct_and_its_control_is_not():
    result, out, checks = _execute(control=True)
    assert result["correct"], checks
    assert out["work"] and all(w["answer_tokens"] == 6 and w["decode_steps"] == 5
                               for w in out["work"])
    assert checks["logprob_gap"]["routes_differ"] is not None
    assert not run.verdict(out, out["control_checks"]), out["control_checks"]
    assert result["metrics"]["audio_x"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(lm_analysis.FAULTS))
def test_a_broken_lm_is_not_correct(fault):
    result, _, checks = _execute(fault)
    assert not result["correct"], checks


def test_a_traced_lm_run_reads_its_metrics():
    result, out, _ = _execute(traced=True)
    ctx = out["ctx"]
    assert "trace" in ctx and result["metrics"]["mfu.lm"]["value"] > 0
    # spans on the CPU carry no device seconds: the span readers stay silent
    assert all(run.per_layer({"per_layer": [{"name": n, "unit": "x"}]}, ctx) == {}
               for n in ("lm.prefill_s", "lm.decode_step_ms", "lm.decode_roofline"))
    fake = dict(ctx, prefill_s=[0.5, 0.4, 0.6], decode_s=[1.0, 1.0], decode_steps=[100, 100],
                decode_bytes=200 * 5e9)
    got = run.per_layer({"per_layer": [{"name": n, "unit": "x"} for n in (
        "lm.prefill_s", "lm.decode_step_ms", "lm.decode_roofline")]}, fake)
    assert got["lm.prefill_s"]["value"] == 0.5 and got["lm.decode_step_ms"]["value"] == 10.0
    assert abs(got["lm.decode_roofline"]["value"] - 100 * 1e12 / 3.35e12 / 2.0) < 1e-9


def test_nothing_the_lm_harness_runs_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import time, json\n"
        "from test_bench_port_lm import tiny_cell\n"
        "from bench_port import run, spec\n"
        "run.environment()\n"
        "run.execute(tiny_cell(), 5, 0.2, True, 'cpu', time.perf_counter())\n"
        "import bench_port.reference.deepseek_v2\n"
        "print(json.dumps(spec.forbidden_modules()))\n"
        % (str(ROOT), str(ROOT / "bench_port" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

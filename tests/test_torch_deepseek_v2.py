"""The port's DeepSeek-V2 LM (``models/lm/deepseek_v2.py``) against the plain
float32 forward of ``deepseek_v2_ref.py``, on the CPU at ``test-small``: a
dense first layer, then 8 routed experts top-2 and a shared expert, YaRN
over an original context of 64 positions, so that prompts past it use the
ramp's every part.

Tolerances. In float32 the port and the reference compute the same
products in another order (blocked attention, grouped expert products,
the absorbed decode attention, f32 sums over at most a few hundred terms):
the logits agree to ``F32_TOL`` = 1e-4, about a hundred f32 ulps at their
size (the widest gap measured is 1.0e-5). In bfloat16, the type the
card runs, every product's output is rounded to 8 bits, so the port is
held to ``BF16_TOL`` = 0.25 in the logits (the widest measured is about
0.06, and 0.21 where a near tie of two experts' scores routes a token
otherwise; at |logit| ~ 4, one bf16 ulp is 2^-6) and to the reference's
greedy token at every step where its two best logits lie further apart
than twice that step's gap.
"""

from __future__ import annotations

import json
import struct
from dataclasses import asdict

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deepseek_v2_ref as ref
from modular_audio_pipeline_tpu_torch.models.lm import LM_MODELS, LLAMA_CONFIGS, LlamaLM, LMModel
from modular_audio_pipeline_tpu_torch.models.lm import deepseek_v2 as ds
from modular_audio_pipeline_tpu_torch.runtime import tracing

CFG = ds.DEEPSEEK_V2_CONFIGS["test-small"]
LITE = ds.DEEPSEEK_V2_CONFIGS["deepseek-v2-lite"]
F32_TOL = 1e-4
BF16_TOL = 0.25


def published(cfg: ds.DeepseekV2Config) -> dict:
    """The configuration under the published ``config.json`` keys."""
    return {
        "num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.n_heads, "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.v_head_dim,
        "kv_lora_rank": cfg.kv_lora_rank, "intermediate_size": cfg.d_ff,
        "moe_intermediate_size": cfg.moe_d_ff, "n_routed_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.top_k, "n_shared_experts": cfg.n_shared,
        "first_k_dense_replace": cfg.first_k_dense, "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "routed_scaling_factor": cfg.routed_scaling, "norm_topk_prob": cfg.norm_topk_prob,
        "rope_scaling": {"factor": cfg.rope_factor, "beta_fast": cfg.beta_fast,
                         "beta_slow": cfg.beta_slow, "mscale": cfg.mscale,
                         "mscale_all_dim": cfg.mscale_all_dim,
                         "original_max_position_embeddings": cfg.rope_original_max,
                         "type": "yarn"},
    }


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return ds.init_params(CFG, torch.Generator().manual_seed(0), dtype=torch.float32)


def tokens(n: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, CFG.vocab_size, n))


def test_yarn_tables_of_the_published_configuration():
    """V2-Lite: the ramp runs from dimension 10 to 23, cos and sin keep
    their scale (mscale over mscale_all_dim is 1) and the softmax scale is
    192^-0.5 m^2 with m = 0.1 0.707 ln 40 + 1."""
    inv, m = ds.yarn_inv_freq(LITE)
    i = torch.arange(32, dtype=torch.float32)
    f_extra = 1.0 / 10000.0 ** (2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    torch.testing.assert_close(inv, f_extra / 40 * ramp + f_extra * (1 - ramp), rtol=1e-6, atol=0)
    assert m == 1.0
    mm = 0.1 * 0.707 * np.log(40) + 1
    assert abs(mm - 1.2608) < 1e-4
    assert abs(ds.softmax_scale(LITE) - 192 ** -0.5 * mm * mm) < 1e-12


@pytest.mark.parametrize("cfg", [CFG, LITE], ids=["test-small", "deepseek-v2-lite"])
def test_rope_tables_equal_the_references(cfg):
    pos = torch.arange(0, 9000, 37) if cfg is LITE else torch.arange(200)
    cos, sin = ds._rope_tables(cfg, pos)
    rc, rs = ref.yarn_cos_sin(published(cfg), int(pos[-1]) + 1)
    h = cfg.qk_rope_dim // 2
    # the same f32 angles; torch's vectorised cos and sin reduce angles of
    # thousands of radians with an error of up to ~2e-5 on tensors laid out
    # otherwise (the reference's tables are twice as wide)
    tol = 5e-5 if cfg is LITE else 1e-6
    torch.testing.assert_close(cos, rc[pos, :h], rtol=0, atol=tol)
    torch.testing.assert_close(sin, rs[pos, :h], rtol=0, atol=tol)
    ramp_mid = ((ds.yarn_inv_freq(cfg)[0] * cfg.rope_factor
                 * cfg.rope_theta ** (torch.arange(0, cfg.qk_rope_dim, 2) / cfg.qk_rope_dim)))
    assert ((ramp_mid > 1.001) & (ramp_mid < cfg.rope_factor - 0.001)).any()  # inside the ramp


@pytest.mark.parametrize("n, q_block", [(40, 64), (150, 32), (150, 7)],
                         ids=["one-block", "blocks", "ragged-blocks"])
def test_prefill_logits_and_latent_cache_equal_the_reference(params, n, q_block):
    toks = tokens(n)
    cache = ds.MLACache.zeros(CFG, 1, n, torch.float32)
    got, cache = ds.forward(params, CFG, toks[None], cache, q_block=q_block)
    want = ref.forward(params, published(CFG), toks)
    assert got.dtype == torch.float32 and cache.pos == n
    torch.testing.assert_close(got[0], want["logits"], rtol=0, atol=F32_TOL)
    torch.testing.assert_close(cache.c_kv[:, 0], want["c_kv"], rtol=0, atol=F32_TOL)
    torch.testing.assert_close(cache.k_pe[:, 0], want["k_pe"], rtol=0, atol=F32_TOL)


def test_prefill_attends_in_query_blocks_and_decode_through_the_latent(params, monkeypatch):
    """Each of the prefill's attention calls sees at most ``q_block``
    queries and the keys up to its own last position (the blocks' causal
    masks); the decode step calls no attention over decompressed keys: it
    reads the cache's latent rows (576 wide at V2-Lite) in the absorbed form."""
    from torch.nn.attention import bias

    seen = []
    real = bias.causal_lower_right
    monkeypatch.setattr(bias, "causal_lower_right", lambda *s: seen.append(s) or real(*s))
    cache = ds.MLACache.zeros(CFG, 1, 101, torch.float32)
    ds.forward(params, CFG, tokens(100)[None], cache, q_block=32)
    assert seen == [(32, 32), (32, 64), (32, 96), (4, 100)] * CFG.n_layers
    assert cache.c_kv.shape[-1] + cache.k_pe.shape[-1] == CFG.kv_lora_rank + CFG.qk_rope_dim
    seen.clear()
    absorbed = []
    real_abs = ds._absorbed_attention
    monkeypatch.setattr(ds, "_absorbed_attention",
                        lambda *a: absorbed.append(a[2].shape) or real_abs(*a))
    ds.forward(params, CFG, tokens(1, 1)[None], cache)
    assert seen == [] and cache.pos == 101
    assert absorbed == [(1, 101, CFG.kv_lora_rank)] * CFG.n_layers
    assert LITE.kv_lora_rank + LITE.qk_rope_dim == 576


@pytest.mark.parametrize("prompt", [30, 90], ids=["inside-original-context", "past-it"])
def test_decode_steps_through_the_latent_cache_equal_the_full_forward(params, prompt):
    """Prefill, then 8 absorbed decode steps, each step's logits against
    the reference's full forward over prompt and steps."""
    toks = tokens(prompt + 8, seed=prompt)
    cache = ds.MLACache.zeros(CFG, 1, prompt + 8, torch.float32)
    steps = []
    logits, cache = ds.forward(params, CFG, toks[None, :prompt], cache, q_block=16,
                               last_only=True)
    steps.append(logits[0, -1])
    for i in range(prompt, prompt + 7):
        logits, cache = ds.forward(params, CFG, toks[None, i:i + 1], cache)
        steps.append(logits[0, -1])
    want = ref.forward(params, published(CFG), toks[:prompt + 7])
    torch.testing.assert_close(torch.stack(steps), want["logits"][prompt - 1:], rtol=0,
                               atol=F32_TOL)
    torch.testing.assert_close(cache.c_kv[:, 0, :prompt + 7], want["c_kv"], rtol=0, atol=F32_TOL)
    torch.testing.assert_close(cache.k_pe[:, 0, :prompt + 7], want["k_pe"], rtol=0, atol=F32_TOL)


def test_greedy_generation_in_bf16_follows_the_reference():
    """bf16, the card's type: the generated tokens are the reference's
    greedy continuation, and every step's logits lie within BF16_TOL."""
    p32 = ds.init_params(CFG, torch.Generator().manual_seed(1), dtype=torch.float32)
    p16 = {k: ({kk: vv.bfloat16() for kk, vv in v.items()} if isinstance(v, dict)
               else v.bfloat16()) for k, v in p32.items()}
    lm = ds.DeepseekV2LM(CFG, params=p16)
    prompt = tokens(70, seed=5)
    out = lm.generate(prompt.numpy(), max_new_tokens=16, temperature=0.0)
    assert len(out) == 16
    seq = torch.cat([prompt, torch.from_numpy(out.astype(np.int64))])
    want = ref.forward({k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                            else v.float()) for k, v in p16.items()},
                       published(CFG), seq)["logits"][69:-1]
    cache = ds.MLACache.zeros(CFG, 1, 86, torch.bfloat16)
    got, cache = ds.forward(p16, CFG, seq[None, :70], cache, q_block=16, last_only=True)
    rows = [got[0, -1]]
    for i in range(70, 85):
        got, cache = ds.forward(p16, CFG, seq[None, i:i + 1], cache)
        rows.append(got[0, -1])
    gaps = (torch.stack(rows) - want).abs().amax(dim=-1)
    assert float(gaps.max()) < BF16_TOL
    # greedy: the reference's choice wherever its two best logits lie
    # further apart than twice that step's gap
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * gaps
    assert clear.sum() >= 6
    assert torch.equal(want.argmax(-1)[clear], seq[70:][clear])


def test_eos_stops_and_no_forward_follows_the_last_token(params, monkeypatch):
    lm = ds.DeepseekV2LM(CFG, params=params)
    calls = []
    real = ds.forward
    monkeypatch.setattr(ds, "forward", lambda *a, **k: calls.append(1) or real(*a, **k))
    out = lm.generate(tokens(20).numpy(), max_new_tokens=6, temperature=0.0)
    assert len(out) == 6 and len(calls) == 6  # the prefill and five decode steps
    calls.clear()
    first = int(out[0])
    out2 = lm.generate(tokens(20).numpy(), max_new_tokens=6, temperature=0.0, eos_id=first)
    assert out2.tolist() == [first] and len(calls) == 1
    a = lm.generate(tokens(20).numpy(), max_new_tokens=5, temperature=0.7, seed=3)
    assert np.array_equal(a, lm.generate(tokens(20).numpy(), max_new_tokens=5,
                                         temperature=0.7, seed=3))


# a published-layout checkpoint, written by hand (safetensors: a little-
# endian header length, a JSON header, the tensors' bytes)
def _write_safetensors(path, tensors):
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float32 and name.endswith("o_proj.weight"):
            # BF16 for some tensors: the upper halves of f32 words
            bits = (arr.view(np.uint32) >> 16).astype("<u2")
            data, dt = bits.tobytes(), "BF16"
        else:
            data, dt = arr.astype("<f4").tobytes(), "F32"
        header[name] = {"dtype": dt, "shape": list(arr.shape), "data_offsets": [off, off + len(data)]}
        blobs.append(data)
        off += len(data)
    head = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def _published_checkpoint(tree, cfg):
    """The port's tree in the published names and ``[out, in]`` layout, the
    RoPE columns put back in their interleaved order."""
    inv = np.argsort(ds.rope_permutation(cfg.qk_rope_dim))
    nope, rope, hd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.qk_head_dim
    q_cols = np.concatenate([h * hd + np.concatenate([np.arange(nope), nope + inv])
                             for h in range(cfg.n_heads)])
    kva_cols = np.concatenate([np.arange(cfg.kv_lora_rank), cfg.kv_lora_rank + inv])
    n = {k: v.numpy() if isinstance(v, torch.Tensor) else {kk: vv.numpy() for kk, vv in v.items()}
         for k, v in tree.items()}
    b, dn, mo = n["blocks"], n["dense"], n["moe"]
    out = {"model.embed_tokens.weight": n["tok_emb"], "model.norm.weight": n["final_norm"],
           "lm_head.weight": n["lm_head"]}
    for i in range(cfg.n_layers):
        p, a = f"model.layers.{i}", f"model.layers.{i}.self_attn"
        out.update({
            f"{p}.input_layernorm.weight": b["attn_norm"][i],
            f"{p}.post_attention_layernorm.weight": b["mlp_norm"][i],
            f"{a}.q_proj.weight": b["w_q"][i][:, q_cols].T,
            f"{a}.kv_a_proj_with_mqa.weight": b["w_kva"][i][:, kva_cols].T,
            f"{a}.kv_a_layernorm.weight": b["kv_norm"][i],
            f"{a}.kv_b_proj.weight": b["w_kvb"][i].T,
            f"{a}.o_proj.weight": b["w_o"][i].T,
        })
        m = f"{p}.mlp"
        if i < cfg.first_k_dense:
            out.update({f"{m}.{w}_proj.weight": dn[f"w_{w}"][i].T for w in ("gate", "up", "down")})
            continue
        j = i - cfg.first_k_dense
        out[f"{m}.gate.weight"] = mo["router"][j].T
        for w in ("gate", "up", "down"):
            out[f"{m}.shared_experts.{w}_proj.weight"] = mo[f"shared_{w}"][j].T
            for e in range(cfg.n_experts):
                out[f"{m}.experts.{e}.{w}_proj.weight"] = mo[f"w_{w}"][j][e].T
    return out


def _bf16_exact(tree):
    """Values a BF16 tensor holds exactly, so a converted BF16 tensor equals its source."""
    return {k: ({kk: vv.bfloat16().float() for kk, vv in v.items()} if isinstance(v, dict)
                else v.bfloat16().float()) for k, v in tree.items()}


def test_converter_reads_the_published_layout_and_permutes_the_rope_columns(tmp_path):
    tree = _bf16_exact(ds.init_params(CFG, torch.Generator().manual_seed(2),
                                      dtype=torch.float32))
    hf = _published_checkpoint(tree, CFG)
    src = tmp_path / "hf"
    src.mkdir()
    names = sorted(hf)
    _write_safetensors(src / "model-00001-of-00002.safetensors",
                       {k: hf[k] for k in names[::2]})
    _write_safetensors(src / "model-00002-of-00002.safetensors",
                       {k: hf[k] for k in names[1::2]})
    ds.convert_hf_deepseek_v2(str(src), str(tmp_path / "out"), "test-small")
    with np.load(tmp_path / "out" / "params.npz") as z:  # bf16 bits, leaves stacked by layer
        assert {z[k].dtype for k in z.files} == {np.dtype(np.uint16)}
        assert z["moe/w_gate"].shape == (CFG.n_moe_layers, CFG.n_experts, CFG.d_model,
                                          CFG.moe_d_ff)
    conv = LM_MODELS["deepseek-v2-lite"].load(str(tmp_path / "out"), "cpu", torch.float32)
    flat = {}

    def walk(a, b, name=""):
        if isinstance(a, dict):
            assert set(a) == set(b), name
            for k in a:
                walk(a[k], b[k], f"{name}/{k}")
        else:
            flat[name] = torch.equal(a, b)

    walk(tree, conv)
    assert all(flat.values()), [k for k, v in flat.items() if not v]
    # the published code's interleaved rotation on the published columns
    # gives the port's numbers
    toks = tokens(90, seed=9)
    published_order = dict(tree, blocks=dict(tree["blocks"]))
    published_order["blocks"]["w_q"] = torch.stack(
        [torch.from_numpy(np.ascontiguousarray(hf[f"model.layers.{i}.self_attn.q_proj.weight"].T))
         for i in range(CFG.n_layers)])
    published_order["blocks"]["w_kva"] = torch.stack(
        [torch.from_numpy(np.ascontiguousarray(
            hf[f"model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight"].T))
         for i in range(CFG.n_layers)])
    want = ref.forward(published_order, published(CFG), toks, interleaved=True)["logits"]
    got, _ = ds.forward(conv, CFG, toks[None], ds.MLACache.zeros(CFG, 1, 90, torch.float32))
    torch.testing.assert_close(got[0], want, rtol=0, atol=F32_TOL)


def test_the_reader_gives_bf16_as_its_bits_mapped(tmp_path):
    """``bf16_bits``: a BF16 tensor comes back as its 16 bits, a view of
    the file's memory map (nothing read yet), the same numbers the widened
    read gives; other types as before."""
    from modular_audio_pipeline_tpu_torch.models.safetensors_reader import load_safetensors

    w = torch.randn(6, 10, generator=torch.Generator().manual_seed(3)).bfloat16().float().numpy()
    path = tmp_path / "m.safetensors"
    _write_safetensors(path, {"a.o_proj.weight": w, "a.norm.weight": w[0]})
    bits = load_safetensors(path, bf16_bits=True)
    wide = load_safetensors(path, bf16_as_f32=True)
    x = bits["a.o_proj.weight"]
    assert x.dtype == np.uint16 and not x.flags.owndata and not x.flags.writeable
    assert np.array_equal((x.astype(np.uint32) << 16).view(np.float32), w)
    assert np.array_equal(wide["a.o_proj.weight"], w)
    assert bits["a.norm.weight"].dtype == np.float32
    assert np.array_equal(bits["a.norm.weight"], w[0])
    assert np.array_equal(ds._bf16_bits(bits["a.norm.weight"]), x[0])


def _toy_tokenizer(dst, vocab_size):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    words = {f"w{i}": i for i in range(vocab_size - 2)}
    words["<unk>"] = vocab_size - 2
    words["</s>"] = vocab_size - 1
    tok = Tokenizer(WordLevel(words, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(dst / "tokenizer.json"))


def test_the_analyzer_builds_each_model_by_name(tmp_path, monkeypatch):
    """``local_model="<dir>::deepseek-v2-test-small"`` (registered for the
    test) builds the DeepSeek-V2 LM with its own end-of-text id, and it
    generates; a llama name still builds ``LlamaLM`` with id 2."""
    from modular_audio_pipeline_tpu_torch import post_processing_hybrid as hybrid
    from modular_audio_pipeline_tpu_torch.models.lm.llama import init_params as llama_init
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import (
        params_to_numpy, save_params)

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    lite = LM_MODELS["deepseek-v2-lite"]
    monkeypatch.setitem(LM_MODELS, "deepseek-v2-test-small", LMModel(CFG, lite.lm, lite.load))
    dsv = tmp_path / "dsv2"
    save_params(params_to_numpy(ds.init_params(CFG, torch.Generator().manual_seed(4),
                                               dtype=torch.float32)), str(dsv))
    _toy_tokenizer(dsv, CFG.vocab_size)
    proc = hybrid.HybridLLMPostProcessor(force_local=True, temperature=0.0,
                                         local_model=f"{dsv}::deepseek-v2-test-small",
                                         lm_device="cpu")
    assert proc.get_backend_info() == {"backend": "local", "model": "deepseek-v2-test-small"}
    an = proc._processor
    assert isinstance(an.lm, ds.DeepseekV2LM) and an.eos_id == CFG.eos_id == 2
    assert an.lm.params["moe"]["w_gate"].dtype == torch.bfloat16
    out = proc.process("alice said hello. bob agreed to ship friday. we will fix the bug.")
    assert isinstance(out, dict) and ("summary" in out or "error" in out)

    lcfg = LLAMA_CONFIGS["test-small"]
    lla = tmp_path / "llama"
    save_params(params_to_numpy(llama_init(lcfg, torch.Generator().manual_seed(0),
                                           dtype=torch.float32)), str(lla))
    _toy_tokenizer(lla, lcfg.vocab_size)
    an = hybrid.LocalLMAnalyzer(str(lla), model_name="test-small", temperature=0.0, device="cpu")
    assert isinstance(an.lm, LlamaLM) and an.eos_id == 2
    assert {n: m.lm for n, m in LM_MODELS.items() if m.lm is LlamaLM}.keys() == LLAMA_CONFIGS.keys()
    assert LM_MODELS["deepseek-v2-lite"].config == LITE
    assert asdict(LITE)["eos_id"] == 100001 and LITE.bos_id == 100000


def _llama():
    lcfg = LLAMA_CONFIGS["test-small"]
    return LlamaLM(lcfg, seed=0), lcfg


@pytest.mark.parametrize("family", ["deepseek-v2", "llama"])
def test_both_lms_record_the_same_spans_and_nothing_without_a_recorder(params, family):
    lm = ds.DeepseekV2LM(CFG, params=params) if family == "deepseek-v2" else _llama()[0]
    prompt = tokens(24).numpy() % 500
    with tracing.record() as rec:
        out = lm.generate(prompt, max_new_tokens=5, temperature=0.0)
    names = [s.name for s in rec.spans]
    assert names == ["lm.generate", "lm.prefill", "lm.decode"]
    assert [rec.spans[i].parent for i in range(3)] == [-1, 0, 0]
    steps = rec.counters["lm.decode_steps"]
    assert steps == (len(out) - 1 if family == "deepseek-v2" else len(out))
    if family == "deepseek-v2":
        assert rec.counters["moe.routed"] == (24 + steps) * CFG.top_k * CFG.n_moe_layers
        assert rec.spans[2].counts["lm.decode_steps"] == steps
    # off: the module-level span is the shared null context
    assert tracing.span("lm.generate") is tracing._NULL
    assert np.array_equal(out, lm.generate(prompt, max_new_tokens=5, temperature=0.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode step's CUDA graph runs only on the card")
    return "cuda"


def test_the_decode_graph_replays_the_eager_step(cuda):
    """On the card, in bf16: the captured decode step, replayed step after
    step, gives the eager step's logits and latent rows (the same kernels;
    the experts' weighted sums add in an order of the card's choosing, so
    the logits are held to 1e-2), and ``generate`` through it gives the
    greedy tokens of the eager loop."""
    p16 = ds.init_params(CFG, torch.Generator(cuda).manual_seed(6), device=cuda)
    toks = tokens(60, seed=6).to(cuda)
    caches = []
    for _ in range(2):
        cache = ds.MLACache.zeros(CFG, 1, 70, torch.bfloat16, cuda)
        ds.forward(p16, CFG, toks[None, :50], cache, last_only=True)
        caches.append(cache)
    graph = ds.DecodeGraph(p16, CFG, caches[0])
    for i in range(50, 59):
        got = graph(toks[None, i:i + 1], i).clone()
        want = ds.decode_step(p16, CFG, toks[None, i:i + 1], caches[1],
                              torch.tensor(i, device=cuda))
        assert float((got - want).abs().max()) < 1e-2
    assert float((caches[0].c_kv[:, :, :59].float() - caches[1].c_kv[:, :, :59].float())
                 .abs().max()) < 1e-2
    lm = ds.DeepseekV2LM(CFG, params=p16, device=cuda)
    out = lm.generate(toks[:50].cpu().numpy(), max_new_tokens=8, temperature=0.0)
    eager = []
    cache = ds.MLACache.zeros(CFG, 1, 58, torch.bfloat16, cuda)
    logits, cache = ds.forward(p16, CFG, toks[None, :50], cache, last_only=True)
    for _ in range(8):
        eager.append(int(logits[0, -1].argmax()))
        logits, cache = ds.forward(p16, CFG, torch.tensor([[eager[-1]]], device=cuda), cache)
    assert out.tolist() == eager

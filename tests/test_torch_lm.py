"""The port's Llama LM and the local tier of the LLM ladder, held against
the JAX package's on the CPU.

At ``test-small`` in float32 with the JAX weights carried across
(``params_from_jax``): the logits of the teacher-forced forward agree to
1e-5 (f32 sums in another order), and greedy tokens are equal. In
bfloat16, the arithmetic the card runs, the port is held to the JAX
program as written: XLA's CPU build by default keeps excess precision
(it may skip a bf16 rounding the program asks for), so the exact pairing
runs the JAX side in a process with ``--xla_allow_excess_precision=false``,
and the default build is held to a looser bf16 tolerance. The
converted HF checkpoint, ``LocalLMAnalyzer`` at temperature 0 and the
hybrid ladder give the JAX package's results; the tests that need
``safetensors`` or ``tokenizers`` skip without them, as tests/test_lm.py's.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_lm
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.models.lm import llama as jax_llama
from modular_audio_pipeline_tpu_torch.models.lm import LLAMA_CONFIGS, LlamaLM
from modular_audio_pipeline_tpu_torch.models.lm import llama as pt_llama
from modular_audio_pipeline_tpu_torch.post_processing_hybrid import extract_json_block

CFG = LLAMA_CONFIGS["test-small"]
LOGIT_TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
BF16_CASES = [([[1, 2, 3, 4, 5]], 16), ([[7, 0, 511, 3], [2, 2, 9, 1]], 8),
              (np.random.default_rng(0).integers(0, 512, (1, 40)).tolist(), 64)]
BF16_PROMPTS = [(np.arange(8), 10), (np.array([5, 300, 7]), 40)]
# bf16 logits against the JAX program as written: each product is summed in
# f32 in another order, and where that flips one bf16 rounding of an
# activation the flip moves on; at |logit| < 8 one bf16 ulp is at most 2^-5
BF16_EXACT_TOL = 2 ** -5
# against XLA's default CPU build, which skips bf16 roundings where it
# likes: up to 2 ulp at |logit| < 8
BF16_DEFAULT_TOL = 2 ** -4


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, the port's tree) of the same float32 weights."""
    jp = jax_llama.init_params(CFG, 0, dtype=jnp.float32)
    return jp, pt_llama.params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def test_configs_equal_jax():
    assert set(LLAMA_CONFIGS) == set(jax_llama.LLAMA_CONFIGS) == {
        "tinyllama-1.1b", "mistral-7b", "test-small"}
    for name, cfg in LLAMA_CONFIGS.items():
        assert cfg.__dict__ == jax_llama.LLAMA_CONFIGS[name].__dict__
        assert cfg.head_dim == jax_llama.LLAMA_CONFIGS[name].head_dim


@pytest.mark.parametrize("tokens, ctx", [([[1, 2, 3, 4, 5]], 16), ([[7, 0, 511, 3], [2, 2, 9, 1]], 8)])
def test_forward_equals_jax(weights, tokens, ctx):
    jp, pp = weights
    want, jcache = jax_llama.forward(jp, CFG, jnp.asarray(tokens, jnp.int32),
                                     jax_llama.LMCache.zeros(CFG, len(tokens), ctx, jnp.float32))
    cache = pt_llama.LMCache.zeros(CFG, len(tokens), ctx, torch.float32)
    got, cache = pt_llama.forward(pp, CFG, torch.tensor(tokens), cache)
    assert got.dtype == torch.float32 and cache.pos == int(jcache.pos) == len(tokens[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), rtol=0, atol=LOGIT_TOL)


_JAX_BF16 = """
import sys
import jax, jax.numpy as jnp, numpy as np
from modular_audio_pipeline_tpu.models.lm import llama as J
cfg = J.LLAMA_CONFIGS["test-small"]
cases, prompts = eval(sys.argv[2])
jp = J.init_params(cfg, 0, dtype=jnp.bfloat16)
out = {"p/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
       for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
for i, (tokens, ctx) in enumerate(cases):
    lg, _ = J.forward(jp, cfg, jnp.asarray(tokens, jnp.int32),
                      J.LMCache.zeros(cfg, len(tokens), ctx, jnp.bfloat16))
    out[f"logits{i}"] = np.asarray(lg)
for i, (prompt, n) in enumerate(prompts):
    out[f"greedy{i}"] = J.LlamaLM(cfg, params=jp).generate(
        np.asarray(prompt, np.int32), max_new_tokens=n, temperature=0.0)
np.savez(sys.argv[1], **out)
"""


def _bf16_tree(flat):
    """The ``p/...`` arrays of an npz -> the port's bf16 tree."""
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")[1:]
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = v
    return pt_llama.params_from_jax(tree, "cpu", torch.bfloat16)


def _port_bf16(pp):
    logits = [pt_llama.forward(pp, CFG, torch.tensor(t), pt_llama.LMCache.zeros(
        CFG, len(t), ctx, torch.bfloat16))[0].numpy() for t, ctx in BF16_CASES]
    greedy = [LlamaLM(CFG, params=pp).generate(p.astype(np.int32), max_new_tokens=n,
                                               temperature=0.0) for p, n in BF16_PROMPTS]
    return logits, greedy


def test_bf16_forward_and_greedy_equal_jax(tmp_path):
    """bf16 weights from the JAX init, the JAX side compiled without excess
    precision: the port's logits within ``BF16_EXACT_TOL`` and its greedy
    tokens equal, so the port rounds where the JAX program rounds."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    spec = repr(([(t, c) for t, c in BF16_CASES], [(p.tolist(), n) for p, n in BF16_PROMPTS]))
    run = subprocess.run([sys.executable, "-c", _JAX_BF16, str(tmp_path / "jax.npz"), spec],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    with np.load(tmp_path / "jax.npz") as z:
        want = dict(z)
    pp = _bf16_tree({k: v for k, v in want.items() if k.startswith("p/")})
    assert pp["tok_emb"].dtype == torch.bfloat16
    logits, greedy = _port_bf16(pp)
    for i, got in enumerate(logits):
        np.testing.assert_allclose(got, want[f"logits{i}"], rtol=0, atol=BF16_EXACT_TOL)
    for i, got in enumerate(greedy):
        np.testing.assert_array_equal(got, want[f"greedy{i}"])


def test_bf16_forward_near_jax_default_build():
    """The same bf16 forward against this process's JAX (XLA's default CPU
    build, excess precision allowed): logits within ``BF16_DEFAULT_TOL``."""
    jp = jax_llama.init_params(CFG, 0, dtype=jnp.bfloat16)
    pp = pt_llama.params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
    assert all(np.array_equal(np.asarray(a, np.float32), b.float().numpy())
               for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(pp)))
    logits, _ = _port_bf16(pp)
    for (tokens, ctx), got in zip(BF16_CASES, logits):
        want, _ = jax_llama.forward(jp, CFG, jnp.asarray(tokens, jnp.int32),
                                    jax_llama.LMCache.zeros(CFG, len(tokens), ctx, jnp.bfloat16))
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=BF16_DEFAULT_TOL)


def test_rms_norm_and_rope_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        pt_llama._rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(),
        np.asarray(jax_llama._rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)), rtol=0, atol=1e-6)
    pos = np.arange(40, 46)
    np.testing.assert_allclose(
        pt_llama._rope(torch.from_numpy(x), *pt_llama._rope_tables(torch.from_numpy(pos), 16,
                                                                   10000.0)).numpy(),
        np.asarray(jax_llama._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), rtol=0, atol=1e-5)


def test_incremental_matches_teacher_forced(weights):
    _, pp = weights
    toks = torch.tensor([[1, 2, 3, 4, 5]])
    full, _ = pt_llama.forward(pp, CFG, toks, pt_llama.LMCache.zeros(CFG, 1, 16, torch.float32))
    cache = pt_llama.LMCache.zeros(CFG, 1, 16, torch.float32)
    outs = []
    for i in range(5):
        lg, cache = pt_llama.forward(pp, CFG, toks[:, i : i + 1], cache)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prompt, max_new", [(np.arange(8), 10), (np.array([5, 300, 7]), 40)])
def test_greedy_generate_equals_jax(weights, prompt, max_new):
    jp, pp = weights
    want = jax_llama.LlamaLM(CFG, params=jp).generate(prompt.astype(np.int32), max_new_tokens=max_new,
                                                      temperature=0.0)
    lm = LlamaLM(CFG, params=pp)
    got = lm.generate(prompt.astype(np.int32), max_new_tokens=max_new, temperature=0.0)
    np.testing.assert_array_equal(got, want)
    assert len(got) == max_new and got.dtype == np.int32
    np.testing.assert_array_equal(got, lm.generate(prompt, max_new_tokens=max_new,
                                                   temperature=0.0))


def test_eos_stops_generation(weights):
    jp, pp = weights
    lm = LlamaLM(CFG, params=pp)
    p = np.arange(8, dtype=np.int32)
    first = int(lm.generate(p, max_new_tokens=1, temperature=0.0)[0])
    out = lm.generate(p, max_new_tokens=10, temperature=0.0, eos_id=first)
    assert len(out) == 1 and int(out[0]) == first
    # an EOS later in the sequence: included, and the rest cut, as in JAX
    full = lm.generate(p, max_new_tokens=10, temperature=0.0)
    eos = int(full[4])
    want = jax_llama.LlamaLM(CFG, params=jp).generate(p, max_new_tokens=10, temperature=0.0,
                                                      eos_id=eos)
    got = lm.generate(p, max_new_tokens=10, temperature=0.0, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    assert int(got[-1]) == eos and eos not in got[:-1].tolist()


def test_sampling_is_reproducible_per_seed(weights):
    """Above temperature 0 the draws come from torch.multinomial (the JAX
    package's categorical draws other numbers: ROADMAP.md §C)."""
    _, pp = weights
    lm = LlamaLM(CFG, params=pp)
    p = np.arange(6, dtype=np.int32)
    a = lm.generate(p, max_new_tokens=12, temperature=0.8, seed=3)
    assert np.array_equal(a, lm.generate(p, max_new_tokens=12, temperature=0.8, seed=3))
    assert len(a) == 12 and (a >= 0).all() and (a < CFG.vocab_size).all()


def test_gqa_head_counts(weights):
    """Query heads come in groups over the KV heads, and each KV head is
    repeated for its group in order (``jnp.repeat``'s order)."""
    _, pp = weights
    assert CFG.n_heads % CFG.n_kv_heads == 0
    assert pp["blocks"]["wk"].shape == (CFG.n_layers, CFG.d_model, CFG.n_kv_heads * CFG.head_dim)
    assert pp["blocks"]["wq"].shape == (CFG.n_layers, CFG.d_model, CFG.n_heads * CFG.head_dim)
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(1, 2, 3, 4)
    np.testing.assert_array_equal(torch.from_numpy(x).repeat_interleave(2, dim=1).numpy(),
                                  np.asarray(jnp.repeat(jnp.asarray(x), 2, axis=1)))
    tiny, mistral = LLAMA_CONFIGS["tinyllama-1.1b"], LLAMA_CONFIGS["mistral-7b"]
    assert (tiny.n_heads // tiny.n_kv_heads, tiny.head_dim) == (8, 64)
    assert (mistral.n_heads // mistral.n_kv_heads, mistral.head_dim) == (4, 128)


def test_init_params_on_a_device_from_a_generator():
    gen = torch.Generator(device="cpu").manual_seed(5)
    a = pt_llama.init_params(CFG, gen, torch.float32, "cpu")
    b = pt_llama.init_params(CFG, torch.Generator(device="cpu").manual_seed(5), torch.float32)
    j = jax_llama.init_params(CFG, 0, dtype=jnp.float32)
    assert jax.tree.map(lambda x: tuple(x.shape), a) == jax.tree.map(lambda x: tuple(x.shape), j)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    lm = LlamaLM(CFG, seed=2, device="cpu")
    assert lm.params["tok_emb"].dtype == torch.bfloat16


# -- converted checkpoints and the local tier -----------------------------------

def _converted(tmp_path, seed):
    """An HF-layout safetensors checkpoint of the JAX init (tests/test_lm.py's
    exporter), converted by the port and by the JAX package, with the toy
    WordLevel tokenizer beside each."""
    pytest.importorskip("safetensors")
    pytest.importorskip("tokenizers")
    src = tmp_path / "hf"
    src.mkdir()
    orig = jax_llama.init_params(CFG, seed=seed, dtype=jnp.float32)
    test_lm.TestConvertedCheckpoint._export_hf_layout(orig, CFG, src)
    dst_pt, dst_jax = tmp_path / "converted_pt", tmp_path / "converted_jax"
    pt_llama.convert_hf_llama(str(src), str(dst_pt), "test-small")
    jax_llama.convert_hf_llama(str(src), str(dst_jax), "test-small")
    for d in (dst_pt, dst_jax):
        test_lm.TestConvertedCheckpoint._write_toy_tokenizer(d, CFG.vocab_size)
    return orig, dst_pt, dst_jax


def test_convert_roundtrip_equals_jax(tmp_path):
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params

    orig, dst_pt, dst_jax = _converted(tmp_path, seed=3)
    with np.load(dst_pt / "params.npz") as a, np.load(dst_jax / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    conv = pt_llama.params_from_jax(load_params(str(dst_pt)), "cpu", torch.float32)
    toks = [[1, 5, 9]]
    want, _ = jax_llama.forward(orig, CFG, jnp.asarray(toks, jnp.int32),
                                jax_llama.LMCache.zeros(CFG, 1, 8, jnp.float32))
    got, _ = pt_llama.forward(conv, CFG, torch.tensor(toks),
                              pt_llama.LMCache.zeros(CFG, 1, 8, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("text", [
    "alice said hello. bob agreed to ship friday.",
    "w3 w7 w9 w11 w400 w2 w2 w2. w17 will w19 the w5.",
])
def test_local_analyzer_equals_jax(tmp_path, monkeypatch, text):
    """LocalLMAnalyzer at temperature 0 on the converted checkpoint, in
    float32 on both sides (both analyzers' bf16 loads bound to f32): the
    same generated tokens and the same result dict."""
    from modular_audio_pipeline_tpu import post_processing_hybrid as jax_hybrid
    from modular_audio_pipeline_tpu.models.whisper import convert as jax_convert
    from modular_audio_pipeline_tpu_torch.post_processing_hybrid import LocalLMAnalyzer

    _, dst_pt, dst_jax = _converted(tmp_path, seed=4)
    real, real_pt = jax_convert.load_params, pt_llama.params_from_jax
    monkeypatch.setattr(jax_convert, "load_params", lambda src, dtype=None: real(src))
    monkeypatch.setattr(pt_llama, "params_from_jax",
                        lambda tree, device, dtype: real_pt(tree, device, torch.float32))
    want = jax_hybrid.LocalLMAnalyzer(str(dst_jax), model_name="test-small", temperature=0.0)
    got = LocalLMAnalyzer(str(dst_pt), model_name="test-small", temperature=0.0, device="cpu")
    assert got.lm.params["tok_emb"].dtype == torch.float32
    ids = np.asarray(got.tokenizer.encode(text).ids, np.int32)
    np.testing.assert_array_equal(got.lm.generate(ids, max_new_tokens=20, temperature=0.0),
                                  want.lm.generate(ids, max_new_tokens=20, temperature=0.0))
    out = got.process(text)
    assert out == want.process(text)
    assert ("summary" in out) or ("error" in out)


def test_hybrid_ladder_equals_jax(tmp_path, monkeypatch):
    """The ladder without an OpenAI key: the local tier on the converted
    checkpoint (bf16, as the JAX package loads it), the same backend info,
    and the same result (random weights write no JSON, so both fall back
    to the heuristic analyzer); without a local model, the heuristic."""
    from modular_audio_pipeline_tpu import post_processing_hybrid as jax_hybrid
    from modular_audio_pipeline_tpu_torch import post_processing_hybrid as pt_hybrid

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    _, dst_pt, dst_jax = _converted(tmp_path, seed=4)
    text = "alice said hello. bob agreed to ship friday. we will fix the bug."
    want = jax_hybrid.HybridLLMPostProcessor(force_local=True, temperature=0.0,
                                             local_model=f"{dst_jax}::test-small")
    got = pt_hybrid.HybridLLMPostProcessor(force_local=True, temperature=0.0,
                                           local_model=f"{dst_pt}::test-small", lm_device="cpu")
    assert got.get_backend_info() == want.get_backend_info() == {
        "backend": "local", "model": "test-small"}
    assert isinstance(got._processor, pt_hybrid.LocalLMAnalyzer)
    assert got._processor.lm.params["tok_emb"].dtype == torch.bfloat16
    assert got.process(text) == want.process(text)

    heur = pt_hybrid.HybridLLMPostProcessor()
    assert heur.get_backend_info() == jax_hybrid.HybridLLMPostProcessor().get_backend_info() == {
        "backend": "heuristic", "model": "extractive-heuristic"}
    assert pt_hybrid.LLMPostProcessor is pt_hybrid.HybridLLMPostProcessor
    # a local model that cannot load leaves the heuristic in place
    broken = pt_hybrid.HybridLLMPostProcessor(local_model=str(tmp_path / "missing"),
                                              lm_device="cpu")
    assert broken.get_backend_info()["backend"] == "heuristic"


class TestJSONExtraction:
    def test_fenced_block(self):
        raw = 'noise ```json\n{"summary": "hi", "topics": ["a"]}\n``` more'
        assert extract_json_block(raw)["summary"] == "hi"

    def test_balanced_object(self):
        raw = 'Answer: {"summary": "ok", "topics": [], "nested": {"x": 1}} trailing'
        assert extract_json_block(raw)["nested"]["x"] == 1

    def test_regex_fallback(self):
        raw = 'gibberish "summary": "partial result" and "alpha" "beta" junk'
        data = extract_json_block(raw)
        assert data["summary"] == "partial result"
        assert data["topics"] == ["alpha", "beta"]

    def test_no_json(self):
        assert extract_json_block("nothing here at all") is None

"""The port's checkpoint conversion held against the JAX package's.

One random test-tiny tree is exported to every source layout the JAX
converter reads (an HF ``pytorch_model.bin``, an HF ``model.safetensors``
in F32 and in F16, an OpenAI ``.pt`` with and without
``model_state_dict``, a ``whisper.pt`` directory) by the exporters of
tests/test_whisper.py::TestConvertReadiness; both converters turn each
into a ``params.npz`` whose members (names, order, ``.npy`` headers and
data) are equal byte for byte. The port's CLI runs where ``jax``, the
JAX package and ``safetensors`` cannot be imported. The port's
safetensors reader equals ``safetensors.numpy`` for every dtype that one
reads and refuses the rest by name; ``convert_hf_llama`` through it equals
the JAX package's converter, BF16 checkpoints included (widened to f32).
"""

import json
import struct
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file
from test_whisper import DIMS
from test_whisper import TestConvertReadiness as _Readiness
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.exceptions import ModelLoadError as JaxModelLoadError
from modular_audio_pipeline_tpu.models.lm.llama import convert_hf_llama as jax_convert_llama
from modular_audio_pipeline_tpu.models.whisper import convert as jax_convert
from modular_audio_pipeline_tpu_torch.exceptions import ModelLoadError
from modular_audio_pipeline_tpu_torch.models.lm.llama import LLAMA_CONFIGS, convert_hf_llama
from modular_audio_pipeline_tpu_torch.models.safetensors_reader import (
    SAFETENSORS_DTYPES,
    load_safetensors,
)
from modular_audio_pipeline_tpu_torch.models.whisper import convert

ROOT = Path(__file__).resolve().parents[1]


def npz_members(path: Path) -> list:
    """(name, bytes) of every member of a ``.npz``, in order: the ``.npy``
    header (dtype, shape, order) and the data, without the zip's dates."""
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i)) for i in z.infolist()]


def assert_same_bundle(got: Path, want: Path):
    a, b = npz_members(got / "params.npz"), npz_members(want / "params.npz")
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert x == y, name


def _tensors(sd, dtype=np.float32):
    return {k: torch.from_numpy(np.ascontiguousarray(v).astype(dtype)) for k, v in sd.items()}


def write_source(layout: str, truth: dict, root: Path) -> Path:
    """``truth`` exported in ``layout`` under ``root`` -> the converter's src."""
    if layout.startswith("hf"):
        sd = _Readiness._export_hf(truth, DIMS)
        src = root / "hf"
        src.mkdir()
        if layout == "hf_bin":
            torch.save(_tensors(sd), src / "pytorch_model.bin")
        else:
            dtype = np.float16 if layout == "hf_safetensors_f16" else np.float32
            save_file({k: np.ascontiguousarray(v).astype(dtype) for k, v in sd.items()},
                      str(src / "model.safetensors"))
        (src / "vocab.json").write_text(json.dumps({"a": 0}))
        (src / "merges.txt").write_text("#version\na b\n")
        return src
    sd = _tensors(_Readiness._export_openai(truth, DIMS))
    if layout == "whisper_pt_dir":
        src = root / "oai"
        src.mkdir()
        torch.save({"model_state_dict": sd}, src / "whisper.pt")
        return src
    src = root / "w.pt"
    if layout == "openai_pt":
        torch.save({"model_state_dict": sd, "dims": {"n_vocab": DIMS.n_vocab}}, src)
    else:  # a bare state dict
        torch.save(sd, src)
    return src


LAYOUTS = ["hf_bin", "hf_safetensors_f32", "hf_safetensors_f16", "openai_pt", "openai_pt_bare",
           "whisper_pt_dir"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_conversion_equals_jax(tmp_path, layout):
    truth = _Readiness._true_tree(DIMS, np.random.default_rng(LAYOUTS.index(layout)))
    src = write_source(layout, truth, tmp_path)
    jax_convert.convert_checkpoint(str(src), str(tmp_path / "jax"), "test-tiny")
    convert.convert_checkpoint(str(src), str(tmp_path / "port"), "test-tiny")
    assert_same_bundle(tmp_path / "port", tmp_path / "jax")
    # the tokenizer assets travel, as the JAX converter copies them
    for asset in ("vocab.json", "merges.txt"):
        assert ((tmp_path / "port" / asset).exists()
                == (tmp_path / "jax" / asset).exists() == layout.startswith("hf"))
    # the unpadded arrays of the source: f16 stays f16 from safetensors,
    # a torch file is read in f32
    flat = dict(np.load(tmp_path / "port" / "params.npz"))
    want = convert.flatten_tree(truth)
    assert set(flat) == set(want)
    for k, v in want.items():
        cast = v.astype(np.float16) if layout == "hf_safetensors_f16" else v
        np.testing.assert_array_equal(flat[k], cast, err_msg=k)
        assert flat[k].dtype == cast.dtype
    # and load_params reads both bundles as the JAX loader does (padded table)
    got = convert.flatten_tree(convert.load_params(str(tmp_path / "port")))
    ref = jax_convert.flatten_tree(jax_convert.load_params(str(tmp_path / "jax")))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_hf_and_openai_agree(tmp_path):
    truth = _Readiness._true_tree(DIMS, np.random.default_rng(4))
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir()
    d2.mkdir()
    convert.convert_checkpoint(str(write_source("hf_bin", truth, d1)), str(tmp_path / "c1"),
                               "test-tiny")
    convert.convert_checkpoint(str(write_source("openai_pt", truth, d2)), str(tmp_path / "c2"),
                               "test-tiny")
    assert_same_bundle(tmp_path / "c1", tmp_path / "c2")


def test_unrecognised_source_raises_in_both(tmp_path):
    src = tmp_path / "empty"
    src.mkdir()
    (src / "README").write_text("no checkpoint here")
    with pytest.raises(ModelLoadError, match="No recognised checkpoint") as got:
        convert.convert_checkpoint(str(src), str(tmp_path / "p"), "test-tiny")
    with pytest.raises(JaxModelLoadError) as want:
        jax_convert.convert_checkpoint(str(src), str(tmp_path / "j"), "test-tiny")
    assert str(got.value) == str(want.value)


_BLOCK = ("import sys\n"
          "for name in ('jax', 'jaxlib', 'modular_audio_pipeline_tpu', 'safetensors'):\n"
          "    sys.modules[name] = None  # any import of these raises ImportError\n"
          "import runpy\n"
          "sys.argv = ['convert'] + sys.argv[1:]\n"
          "runpy.run_module('modular_audio_pipeline_tpu_torch.models.whisper.convert',"
          " run_name='__main__')\n"
          "assert not any(m.split('.')[0] in ('jax', 'modular_audio_pipeline_tpu', 'safetensors')"
          " for m, v in sys.modules.items() if v is not None)\n")


@pytest.mark.parametrize("layout", ["hf_safetensors_f32", "openai_pt"])
def test_cli_without_jax_or_safetensors_equals_jax(tmp_path, layout):
    truth = _Readiness._true_tree(DIMS, np.random.default_rng(7))
    src = write_source(layout, truth, tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK, "--src", str(src), "--dst", str(tmp_path / "port"),
         "--model", "test-tiny"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jax_convert.convert_checkpoint(str(src), str(tmp_path / "jax"), "test-tiny")
    assert_same_bundle(tmp_path / "port", tmp_path / "jax")


def _sample(dtype: str, rng, shape) -> np.ndarray:
    return np.asarray(_draw(dtype, rng, shape))


def _draw(dtype: str, rng, shape):
    np_type = np.dtype(SAFETENSORS_DTYPES[dtype])
    if np_type.kind == "b":
        return rng.integers(0, 2, shape).astype(bool)
    if np_type.kind in "iu":
        info = np.iinfo(np_type)
        return rng.integers(info.min, info.max, shape, dtype=np_type, endpoint=True)
    if np_type.kind == "c":
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np_type)
    x = np.asarray(rng.standard_normal(shape)).astype(np_type)
    x.flat[:3] = [np.inf, -0.0, np.nan][: x.size]
    return x


@pytest.mark.parametrize("dtype", sorted(SAFETENSORS_DTYPES))
def test_reader_equals_safetensors_numpy(tmp_path, dtype):
    rng = np.random.default_rng(sorted(SAFETENSORS_DTYPES).index(dtype))
    tensors = {"a.weight": _sample(dtype, rng, (5, 7)), "b": _sample(dtype, rng, (3,)),
               "scalar": _sample(dtype, rng, ()), "empty": _sample(dtype, rng, (0, 4)),
               "c.3d": _sample(dtype, rng, (2, 3, 4))}
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got, want = load_safetensors(path), load_file(str(path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _raw_file(path: Path, dtype: str, nbytes: int):
    header = json.dumps({"w": {"dtype": dtype, "shape": [2, 3],
                               "data_offsets": [0, 6 * nbytes]}}).encode()
    path.write_bytes(struct.pack("<Q", len(header)) + header + bytes(range(6 * nbytes)))


_NUMPY_ONLY = ("import sys\n"
               "from safetensors.numpy import load_file\n"
               "try:\n"
               "    load_file(sys.argv[1])\n"
               "except (TypeError, AttributeError) as exc:\n"
               "    print(type(exc).__name__)\n"
               "print('ml_dtypes' in sys.modules)\n")


@pytest.mark.parametrize("dtype", ["BF16", "F8_E4M3", "F8_E5M2"])
def test_reader_refuses_what_safetensors_numpy_cannot_read(tmp_path, dtype):
    """numpy has no such type: ``safetensors.numpy`` raises in a process
    that never imported jax (whose ``ml_dtypes`` registers ``bfloat16``);
    the port's reader raises a ModelLoadError that names the dtype."""
    path = tmp_path / "w.safetensors"
    _raw_file(path, dtype, 2 if dtype == "BF16" else 1)
    proc = subprocess.run([sys.executable, "-c", _NUMPY_ONLY, str(path)], capture_output=True,
                          text=True, timeout=60)
    assert proc.stdout.split() in (["TypeError", "False"], ["AttributeError", "False"]), proc
    with pytest.raises(ModelLoadError, match=dtype):
        load_safetensors(path)


def test_bf16_gives_the_jax_converter_no_usable_bundle(tmp_path):
    """With jax imported (as the JAX package's CLI imports it) the JAX
    converter reads BF16 through ``ml_dtypes`` but writes raw ``|V2``
    leaves, which the JAX loader does not cast; the port refuses the file
    at conversion instead."""
    import ml_dtypes

    truth = _Readiness._true_tree(DIMS, np.random.default_rng(9))
    src = tmp_path / "hf"
    src.mkdir()
    save_file({k: np.ascontiguousarray(v).astype(ml_dtypes.bfloat16)
               for k, v in _Readiness._export_hf(truth, DIMS).items()},
              str(src / "model.safetensors"))
    jax_convert.convert_checkpoint(str(src), str(tmp_path / "jax"), "test-tiny")
    leaf = jax_convert.load_params(str(tmp_path / "jax"), dtype="float32")["encoder"]["ln_post"]["g"]
    assert leaf.dtype.kind == "V"
    with pytest.raises(ModelLoadError, match="BF16"):
        convert.convert_checkpoint(str(src), str(tmp_path / "port"), "test-tiny")
    assert not (tmp_path / "port").exists()


def test_reader_refuses_a_damaged_file(tmp_path):
    path = tmp_path / "w.safetensors"
    _raw_file(path, "F32", 4)
    path.write_bytes(path.read_bytes()[:-5])  # the last tensor runs past the end
    with pytest.raises(ModelLoadError, match="data offsets"):
        load_safetensors(path)
    path.write_bytes(struct.pack("<Q", 1 << 40) + b"{}")
    with pytest.raises(ModelLoadError, match="header length"):
        load_safetensors(path)


def _hf_llama(cfg, rng, tied: bool) -> dict:
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
    sd = {"model.embed_tokens.weight": rng.standard_normal((cfg.vocab_size, d)),
          "model.norm.weight": rng.standard_normal(d)}
    if not tied:
        sd["lm_head.weight"] = rng.standard_normal((cfg.vocab_size, d))
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        sd.update({
            f"{p}.input_layernorm.weight": rng.standard_normal(d),
            f"{p}.self_attn.q_proj.weight": rng.standard_normal((d, d)),
            f"{p}.self_attn.k_proj.weight": rng.standard_normal((kv, d)),
            f"{p}.self_attn.v_proj.weight": rng.standard_normal((kv, d)),
            f"{p}.self_attn.o_proj.weight": rng.standard_normal((d, d)),
            f"{p}.post_attention_layernorm.weight": rng.standard_normal(d),
            f"{p}.mlp.gate_proj.weight": rng.standard_normal((cfg.d_ff, d)),
            f"{p}.mlp.up_proj.weight": rng.standard_normal((cfg.d_ff, d)),
            f"{p}.mlp.down_proj.weight": rng.standard_normal((d, cfg.d_ff)),
        })
    return sd


@pytest.mark.parametrize("tied,dtype", [(False, np.float32), (True, np.float16)])
def test_convert_hf_llama_equals_jax(tmp_path, monkeypatch, tied, dtype):
    cfg = LLAMA_CONFIGS["test-small"]
    sd = _hf_llama(cfg, np.random.default_rng(11), tied)
    src = tmp_path / "hf"
    src.mkdir()
    keys = sorted(sd)  # two shards, as a sharded HF checkpoint
    for i, part in enumerate((keys[::2], keys[1::2])):
        save_file({k: sd[k].astype(dtype) for k in part},
                  str(src / f"model-0000{i + 1}-of-00002.safetensors"))
    jax_convert_llama(str(src), str(tmp_path / "jax"), "test-small")
    for name in ("safetensors", "safetensors.numpy"):  # the port must not need it
        monkeypatch.setitem(sys.modules, name, None)
    convert_hf_llama(str(src), str(tmp_path / "port"), "test-small")
    assert_same_bundle(tmp_path / "port", tmp_path / "jax")


def test_params_to_numpy_widens_bf16_exactly():
    """numpy has no bfloat16: a bf16 leaf comes back as f32 with its value,
    and params_from_numpy rounds it back to the same bits."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16)},
            "s": torch.randn((3,), generator=g), "i": torch.arange(4, dtype=torch.int8)}
    host = convert.params_to_numpy(tree)
    assert (host["a"]["w"].dtype, host["s"].dtype, host["i"].dtype) == (
        np.float32, np.float32, np.int8)
    np.testing.assert_array_equal(host["a"]["w"], tree["a"]["w"].float().numpy())
    back = convert.params_from_numpy(host, "cpu", torch.bfloat16)
    assert torch.equal(back["a"]["w"].view(torch.int16), tree["a"]["w"].view(torch.int16))


def test_bf16_llama_is_widened_as_the_jax_converter_widens_it(tmp_path, monkeypatch):
    """With jax imported the JAX Llama converter reads BF16 through
    ``ml_dtypes`` and writes f32; the port's reader widens the same bits
    itself (``bf16_as_f32``), so both bundles are equal byte for byte. The
    reader's widening equals ``ml_dtypes``' for every bit pattern, NaNs,
    infinities and signed zeros included."""
    import ml_dtypes

    cfg = LLAMA_CONFIGS["test-small"]
    sd = _hf_llama(cfg, np.random.default_rng(12), tied=True)
    src = tmp_path / "hf"
    src.mkdir()
    save_file({k: v.astype(ml_dtypes.bfloat16) for k, v in sd.items()},
              str(src / "model.safetensors"))
    jax_convert_llama(str(src), str(tmp_path / "jax"), "test-small")
    with np.load(tmp_path / "jax" / "params.npz") as z:
        assert z["tok_emb"].dtype == np.float32
    for name in ("safetensors", "safetensors.numpy", "ml_dtypes"):  # the port needs none
        monkeypatch.setitem(sys.modules, name, None)
    convert_hf_llama(str(src), str(tmp_path / "port"), "test-small")
    assert_same_bundle(tmp_path / "port", tmp_path / "jax")

    every = np.arange(1 << 16, dtype=np.uint16)
    path = tmp_path / "all.safetensors"
    save_file({"w": every.view(ml_dtypes.bfloat16).reshape(256, 256)}, str(path))
    got = load_safetensors(path, bf16_as_f32=True)["w"]
    want = every.view(ml_dtypes.bfloat16).astype(np.float32).reshape(256, 256)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    with pytest.raises(ModelLoadError, match="BF16"):
        load_safetensors(path)

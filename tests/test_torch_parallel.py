"""The port's mesh (``parallel/mesh.py``, ``parallel/sharding.py``) against
the JAX package's, on the CPU.

Counterpart of ``tests/test_parallel.py``: its cases (``TestMesh``,
``TestParamSharding``, ``TestTrainStep``, ``TestTPInference``,
``TestBatchDriverMesh``) and the checks of
``__graft_entry__.dryrun_multichip`` (a training step, a DP beam decode and
a serving ``process`` under a data x model mesh). The JAX side runs in this
process on the 8-device virtual mesh of ``tests/conftest.py``; the port runs
one process per rank, as under ``torchrun``: worlds of 4 ranks spawned over
gloo (``tests/torch_mesh_worker.py``, which imports no JAX) at ``{data: 2,
model: 2}`` and ``{data: 4}``, and a world of one rank at ``{data: 1}``,
all three at once while this process computes the JAX references. Each
world runs every check of its shape once (a module-scoped fixture) and the
cases below assert on the results. Every collective has a 45 s timeout and
every world a deadline after which its ranks are killed and the fixture
fails, so a rank that diverges shows as a failure, never as a hang.

Tolerances are the JAX test's: tokens equal, log-probabilities and no-speech
probabilities within 2e-3 (tensor-parallel partial sums round apart in the
last bits); training losses within 1e-4 of the JAX run's under ``{data: 2,
model: 2}`` (the same global batch on every mesh).
"""

import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from test_parallel import TestBatchDriverMesh as JaxBatchCase
from torch_mesh_worker import spawn_world

from modular_audio_pipeline_tpu.config import PipelineConfig as JaxConfig
from modular_audio_pipeline_tpu.config import TPUConfig as JaxTPUConfig
from modular_audio_pipeline_tpu.models.whisper.config import WHISPER_DIMS
from modular_audio_pipeline_tpu.models.whisper.convert import save_params
from modular_audio_pipeline_tpu.models.whisper.decode import DecodeOptions, decode_windows
from modular_audio_pipeline_tpu.models.whisper.model import init_params
from modular_audio_pipeline_tpu.models.whisper.tokenizer import DummyTokenizer
from modular_audio_pipeline_tpu.ops.mel import log_mel
from modular_audio_pipeline_tpu.parallel.batch import BatchDriver as JaxBatchDriver
from modular_audio_pipeline_tpu.parallel.mesh import build_mesh as jax_build_mesh
from modular_audio_pipeline_tpu.parallel.sharding import shard_params as jax_shard_params
from modular_audio_pipeline_tpu.parallel.sharding import whisper_param_specs as jax_specs
from modular_audio_pipeline_tpu.audio_io import write_wav
from modular_audio_pipeline_tpu.serving import ServingPipeline as JaxServing
from modular_audio_pipeline_tpu.training import make_train_step as jax_train_step
from modular_audio_pipeline_tpu.transcriber import WhisperTranscriber as JaxTranscriber
from modular_audio_pipeline_tpu_torch.config import TPUConfig
from modular_audio_pipeline_tpu_torch.exceptions import ShardingError
from modular_audio_pipeline_tpu_torch.parallel.mesh import build_mesh
from modular_audio_pipeline_tpu_torch.parallel.sharding import whisper_param_specs

DIMS = WHISPER_DIMS["test-tiny"]
ROOT = Path(__file__).resolve().parents[1]
PROXY = ROOT / "modular_audio_pipeline_tpu" / "weights" / "whisper-tiny-synth-proxy"
MESHES = {"2x2": {"data": 2, "model": 2}, "d4": {"data": 4}, "d1": {"data": 1}}
TOL = 2e-3  # tokens equal; logprobs and no-speech within this (tests/test_parallel.py)
LOSS_TOL = 1e-4
DECODE_OPTS = dict(language="en", beam_size=3, max_tokens=12)
N_FILES = JaxBatchCase.N_FILES


def serving_speech() -> np.ndarray:
    """The 50 s voiced file of ``dryrun_multichip``'s serving proof."""
    sr = 16000
    tt = np.arange(50 * sr) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * tt)
    speech = sum((0.3 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / sr) for k in range(1, 5))
    speech = (speech * (np.sin(2 * np.pi * 1.1 * tt) > -0.4) * 0.3).astype(np.float32)
    speech += 0.002 * np.random.default_rng(2).standard_normal(len(speech)).astype(np.float32)
    return speech


def serving_config() -> JaxConfig:
    """``dryrun_multichip``'s serving configuration (64-token budget, beam 5,
    words, the int8 KV cache, the trained VAD and diarization)."""
    cfg = JaxConfig(media_dir="/tmp")
    t = cfg.transcription
    t.model, t.weights_path, t.language = "test-tiny", "random:0", "en"
    t.beam_size, t.max_decode_tokens, t.batch_size = 5, 64, 4
    t.word_timestamps, t.compute_type = True, "float32"
    return cfg


def outputs(results: Path) -> dict:
    out = {}
    for i in range(N_FILES):
        data = json.loads((results / f"file{i}_transcription.json").read_text())
        out[f"file{i}"] = [(round(s["start"], 3), round(s["end"], 3), s["text"], s.get("speaker"))
                           for s in data["segments"]]
    return out


def seg_key(segs):
    return [(round(s["start"], 3), round(s["end"], 3), s["text"], s.get("words")) for s in segs]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the three worlds, compute the JAX references meanwhile, and
    return ``(worlds, refs, inputs)``."""
    d = tmp_path_factory.mktemp("mesh")
    params = init_params(DIMS, seed=0, dtype=jnp.float32)  # the JAX backend's random:0
    save_params(jax.tree.map(np.asarray, params), str(d / "w"))
    audio = (0.1 * np.random.default_rng(7).standard_normal((4, 16000 * 30))).astype(np.float32)
    mel = np.asarray(log_mel(jnp.asarray(audio), n_mels=DIMS.n_mels))
    np.save(d / "mel.npy", mel)
    rng = np.random.default_rng(0)
    train_mel = rng.standard_normal((8, DIMS.n_mels, 3000)).astype(np.float32)
    tokens = rng.integers(0, DIMS.n_vocab, (8, 12)).astype(np.int32)
    np.save(d / "tmel.npy", train_mel)
    np.save(d / "tok.npy", tokens)
    speech = serving_speech()
    np.save(d / "speech.npy", speech)
    (d / "serve.json").write_text(json.dumps(serving_config().to_dict()))
    write_wav(str(d / "speech.wav"), speech, 16000)
    tcfg = serving_config()
    tcfg.tpu.mesh_shape = dict(MESHES["2x2"])
    (d / "transcribe.json").write_text(json.dumps(tcfg.to_dict()))
    case = JaxBatchCase()
    media = case._make_media(d, "media")

    worlds, errors, threads = {}, {}, []
    for name, shape in MESHES.items():
        spec = {"world": int(np.prod(list(shape.values()))), "mesh": shape,
                "tree": str(d / "w" / "params.npz"), "probe": {},
                "decode": {"mel": str(d / "mel.npy"), "opts": DECODE_OPTS},
                "train": {"mel": str(d / "tmel.npy"), "tokens": str(d / "tok.npy"),
                          "targets": str(d / "tok.npy")}}
        if name != "d1":
            cfg = case._config(media, d / f"results_{name}", shape)
            (d / f"batch_{name}.json").write_text(json.dumps(cfg.to_dict()))
            spec["batch"] = {"config": str(d / f"batch_{name}.json")}
        if name != "2x2":  # AudioPipeline per file: under {data: 4} and unmeshed
            cfg = case._config(media, d / f"pipeline_{name}", shape)
            cfg.temp_dir = str(d / f"temp_{name}")
            (d / f"pipeline_{name}.json").write_text(json.dumps(cfg.to_dict()))
            spec["pipeline_batch"] = {"config": str(d / f"pipeline_{name}.json")}
        if name == "2x2":
            spec["serving"] = {"config": str(d / "serve.json"), "audio": str(d / "speech.npy")}
            spec["verified_load"] = {"bundle": str(PROXY), "model": "tiny"}
            spec["transcribe"] = {"config": str(d / "transcribe.json"),
                                  "wav": str(d / "speech.wav")}

        def go(name=name, spec=spec):
            try:
                worlds[name] = spawn_world(spec, d / f"world_{name}", deadline_s=240.0)
            except Exception as exc:  # reported by the cases that read this world
                errors[name] = exc

        threads.append(threading.Thread(target=go))
        threads[-1].start()

    refs = {"params": params}
    refs["decode"] = decode_windows(params, DIMS, DummyTokenizer(), jnp.asarray(mel),
                                    DecodeOptions(**DECODE_OPTS))
    for name in ("2x2",):  # every world is held to the JAX data x model run
        mesh = jax_build_mesh(JaxTPUConfig(mesh_shape=MESHES[name]))
        with mesh:
            placed = jax_shard_params(params, mesh)
            init_state, train_step = jax_train_step(DIMS)
            state = init_state(placed)
            m = jax.device_put(train_mel, NamedSharding(mesh, P("data", None, None)))
            t = jax.device_put(tokens, NamedSharding(mesh, P("data", None)))
            step = jax.jit(train_step)
            state1, loss1 = step(state, m, t, t)
            state2, loss2 = step(state1, m, t, t)
        refs[f"train_{name}"] = (float(loss1), float(loss2),
                                 np.asarray(state2.params["decoder"]["blocks"]["attn"]["q_w"]))
        refs[f"placed_{name}"] = placed
        refs[f"mesh_{name}"] = mesh
    refs["serving"] = JaxServing(serving_config()).process(speech, 16000)
    refs["transcribe"] = JaxTranscriber.from_config(serving_config()).transcribe(
        str(d / "speech.wav"))
    JaxBatchDriver(case._config(media, d / "results_jax")).run(serving=True)
    refs["batch"] = outputs(d / "results_jax")
    for th in threads:
        th.join()
    return worlds, errors, refs, d


def world(run, name):
    worlds, errors, _, _ = run
    if name in errors:
        raise errors[name]
    return worlds[name]


class TestMesh:
    @pytest.mark.parametrize("name", ["2x2", "d4"])
    def test_default_mesh_uses_all_devices(self, run, name):
        for r in world(run, name):
            assert r["probe"]["default_shape"] == {"data": 4}

    def test_explicit_shape(self, run):
        ranks = world(run, "2x2")
        assert all(r["probe"]["shape"] == {"data": 2, "model": 2} for r in ranks)
        # rank r sits at (r // 2, r % 2), as the JAX device array reshaped
        assert [r["probe"]["coords"] for r in ranks] == [
            {"data": i // 2, "model": i % 2} for i in range(4)]

    def test_too_many_devices_raises(self):
        with pytest.raises(ShardingError, match="torchrun"):
            build_mesh(TPUConfig(mesh_shape={"data": 1024}), "cpu")

    @pytest.mark.parametrize("name", ["2x2", "d4"])
    def test_mesh_smaller_than_world_raises(self, run, name):
        assert all(r["probe"]["smaller_raises"] for r in world(run, name))

    @pytest.mark.parametrize("name", ["2x2", "d4"])
    def test_placements_name_the_sharded_axis(self, run, name):
        """``data_sharding``/``batch_spec`` shard the leading dim on 'data'
        and replicate over 'model' (JAX ``P("data", None)``);
        ``replicated`` replicates over every axis (JAX ``P()``)."""
        from torch.distributed.tensor import Replicate, Shard

        axes = list(MESHES[name])
        shard = tuple(Shard(0) if a == "data" else Replicate() for a in axes)
        want = [repr(shard), repr(tuple(Replicate() for _ in axes)), repr(shard)]
        assert all(r["probe"]["placements"] == want for r in world(run, name))

    def test_shard_batch_pads_and_places(self, run):
        ranks = world(run, "d4")
        batch = np.arange(5 * 16, dtype=np.float32).reshape(5, 16)
        blocks = [r["probe"]["block"] for r in ranks]
        assert all(n == 5 and b.shape == (2, 16) for b, n in blocks)
        padded = np.concatenate([b for b, _ in blocks])
        assert padded.shape == (8, 16)  # padded to a multiple of the axis size
        np.testing.assert_array_equal(padded[:5], batch)
        np.testing.assert_array_equal(padded[5:], 0.0)


class TestParamSharding:
    def test_tp_placement(self, run):
        """Each rank's slices are the JAX sharded arrays' shards on the
        device at the same mesh position."""
        _, _, refs, _ = run
        placed, mesh = refs["placed_2x2"], refs["mesh_2x2"]
        leaves = {
            "enc_q_w": placed["encoder"]["blocks"]["attn"]["q_w"],
            "q_b": placed["decoder"]["blocks"]["attn"]["q_b"],
            "o_w": placed["decoder"]["blocks"]["attn"]["o_w"],
            "o_b": placed["decoder"]["blocks"]["attn"]["o_b"],
            "tok_emb": placed["decoder"]["tok_emb"],
            "conv1_w": placed["encoder"]["conv1"]["w"],
        }
        assert leaves["enc_q_w"].sharding.spec == P(None, None, "model")
        assert leaves["o_w"].sharding.spec == P(None, "model", None)
        devices = np.asarray(mesh.devices)
        for r in world(run, "2x2"):
            c = r["probe"]["coords"]
            dev = devices[c["data"], c["model"]]
            for key, arr in leaves.items():
                shard = next(s for s in arr.addressable_shards if s.device == dev)
                np.testing.assert_array_equal(r["probe"][key], np.asarray(shard.data), key)

    def test_replicated_when_no_model_axis(self, run):
        _, _, refs, _ = run
        whole = np.asarray(refs["params"]["encoder"]["blocks"]["attn"]["q_w"])
        for r in world(run, "d4"):
            np.testing.assert_array_equal(r["probe"]["enc_q_w"], whole)

    def test_spec_tree_is_the_jax_tree(self):
        """Every leaf shards the dim the JAX PartitionSpec puts on 'model'."""
        def walk(j, p, path=""):
            for k in j:
                if isinstance(j[k], dict):
                    assert isinstance(p[k], dict), path + k
                    walk(j[k], p[k], f"{path}{k}/")
                else:
                    spec = tuple(j[k])
                    want = spec.index("model") if "model" in spec else None
                    assert p[k] == want, (path + k, spec, p[k])
            assert set(j) == set(p), path

        walk(jax_specs("model"), whisper_param_specs("model"))

    @pytest.mark.parametrize("name", ["2x2", "d4"])
    def test_int8_tree_is_replicated(self, run, name):
        """A weight-only int8 tree has no TP spec: the backend keeps the
        whole tree (the JAX package's fallback, made explicit)."""
        for r in world(run, name):
            assert r["probe"]["int8_raises"] == (name == "2x2")
            assert not r["probe"]["int8_sharded"]
            assert r["probe"]["int8_q_w_shape"] == (DIMS.n_audio_layer, DIMS.n_audio_state,
                                                    DIMS.n_audio_state)


class TestTrainStep:
    @pytest.mark.parametrize("name", ["2x2", "d4", "d1"])
    def test_one_step_decreases_nothing_catastrophic(self, run, name):
        _, _, refs, _ = run
        loss1, loss2, _ = refs["train_2x2"]
        for r in world(run, name):
            t = r["train"]
            assert np.isfinite(t["loss1"]) and np.isfinite(t["loss2"])
            assert t["loss2"] < t["loss1"]  # same batch twice: AdamW lowers the loss
            assert t["step"] == 2
            assert abs(t["loss1"] - loss1) <= LOSS_TOL and abs(t["loss2"] - loss2) <= LOSS_TOL

    @pytest.mark.parametrize("name", ["2x2", "d4"])
    def test_gathered_parameters_follow_the_jax_step(self, run, name):
        """The sharded leaves, gathered after two steps, are the JAX data x
        model state's (the update is 1e-5 scaled: within 1e-6)."""
        _, _, refs, _ = run
        want = refs["train_2x2"][2]
        for r in world(run, name):
            np.testing.assert_allclose(r["train"]["q_w_after"], want, rtol=0, atol=1e-6)

    def test_loss_masking(self):
        from modular_audio_pipeline_tpu_torch.training.whisper_train import (
            IGNORE_INDEX,
            cross_entropy_loss,
        )

        logits = torch.zeros((1, 4, 10))
        targets = torch.tensor([[1, 2, IGNORE_INDEX, IGNORE_INDEX]])
        loss = cross_entropy_loss(logits, targets)
        # uniform logits -> loss = log(10) over the 2 unmasked positions
        assert float(loss) == pytest.approx(np.log(10), rel=1e-5)


class TestTPInference:
    @pytest.mark.parametrize("name", ["2x2", "d4", "d1"])
    def test_sharded_beam_decode_matches_unsharded(self, run, name):
        _, _, refs, _ = run
        ref = refs["decode"]
        for r in world(run, name):
            got = r["decode"]
            np.testing.assert_allclose(got["sum_logprobs"], ref.sum_logprobs, rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(got["tokens"], ref.tokens)
            np.testing.assert_allclose(got["no_speech_probs"], ref.no_speech_probs,
                                       rtol=TOL, atol=TOL)

    def test_every_rank_decodes_its_rows_and_agrees(self, run):
        """Each data rank decoded its contiguous block; the model ranks of a
        block took the same beam decisions (equal tokens), so no rank can
        have skipped a collective."""
        ranks = world(run, "2x2")
        assert [r["decode"]["lo"] for r in ranks] == [0, 0, 2, 2]
        for r in ranks:
            np.testing.assert_array_equal(r["decode"]["local_tokens"],
                                          r["decode"]["tokens"][r["decode"]["lo"]:][:2])
            np.testing.assert_array_equal(r["decode"]["tokens"], ranks[0]["decode"]["tokens"])


class TestBatchDriverMesh:
    @pytest.mark.parametrize("name", ["2x2", "d4"])
    def test_serving_batch_under_mesh_equals_unmeshed(self, run, name):
        _, _, refs, d = run
        for r in world(run, name):
            assert r["batch"]["first"]["succeeded"] == N_FILES, r["batch"]
            assert r["batch"]["first"]["failed"] == 0
        assert outputs(d / f"results_{name}") == refs["batch"]
        assert any(len(v) > 0 for v in refs["batch"].values())

    @pytest.mark.parametrize("name", ["2x2", "d4"])
    def test_batch_resume_ledger_under_mesh(self, run, name):
        for r in world(run, name):
            again = r["batch"]["again"]
            assert again["skipped"] == N_FILES
            assert again["succeeded"] == 0 and again["failed"] == 0


    def test_pipeline_batch_under_mesh_equals_unmeshed(self, run):
        """``BatchDriver.run()`` (``AudioPipeline`` per file, the
        transcriber's mesh from ``tpu.mesh_shape``, every rank's scratch its
        own, rank 0 the one writer) under ``{data: 4}`` gives the unmeshed
        port run's outputs (the unmeshed run equals the JAX BatchDriver's:
        ``tests/test_torch_batch.py``), and resumes."""
        _, _, _, d = run
        for r in world(run, "d4") + world(run, "d1"):
            assert r["pipeline_batch"]["first"]["succeeded"] == N_FILES
            assert r["pipeline_batch"]["again"]["skipped"] == N_FILES
        assert outputs(d / "pipeline_d4") == outputs(d / "pipeline_d1")
        assert sorted(p.name for p in d.glob("temp_d4*")) == [
            "temp_d4", "temp_d4.rank1", "temp_d4.rank2", "temp_d4.rank3"]


class TestDryrun:
    def test_serving_process_under_mesh_equals_unmeshed(self, run):
        """``dryrun_multichip``'s serving proof: segments with their DTW
        words, speaker turns and mappings under the data x model mesh equal
        the unmeshed JAX run's, on every rank."""
        _, _, refs, _ = run
        ref = refs["serving"]
        for r in world(run, "2x2"):
            got = r["serving"]
            assert seg_key(got["segments"]) == seg_key(ref["segments"])
            assert any(s.get("words") for s in got["segments"])
            assert got["diarization"] == ref["diarization"]
            assert got["timestamp_mappings"] == [tuple(vars(m).values())
                                                 for m in ref["timestamp_mappings"]]

    def test_transcriber_under_mesh_equals_unmeshed(self, run):
        """``WhisperTranscriber.from_config`` with ``tpu.mesh_shape`` (its
        windows over ``data``, its heads over ``model``; words by DTW on the
        rank that decoded each window, gathered): the unmeshed JAX
        transcriber's segments and words."""
        _, _, refs, _ = run
        ref = refs["transcribe"]["segments"]
        for r in world(run, "2x2"):
            assert r["transcribe"]["windows"] == 2
            assert seg_key(r["transcribe"]["segments"]) == seg_key(ref)
        assert any(s.get("words") for s in ref)

    def test_ranks_import_no_jax(self, run):
        for name in MESHES:
            assert not any(r["jax_imported"] for r in world(run, name))

    def test_verified_load_slices_and_casts_before_upload(self, run):
        """The bundle goes up cast (bf16) and sliced for this rank (6 heads:
        3 a rank), and the model holds exactly the verified tensors."""
        tiny = WHISPER_DIMS["tiny"]
        for r in world(run, "2x2"):
            v = r["verified_load"]
            assert v["dtypes"] == ["torch.bfloat16"]
            assert v["q_w"] == (tiny.n_text_layer, tiny.n_text_state, tiny.n_text_state // 2)
            assert v["held_is_verified"] and v["uploads"] >= 1

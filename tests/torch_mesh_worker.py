"""One rank of a spawned gloo world for the port's mesh tests.

    python tests/torch_mesh_worker.py SPEC_JSON RANK

Imports torch and the port, never JAX: the parent test runs the JAX
reference. ``SPEC_JSON`` names the world (size, mesh shape, a ``file://``
store), the numpy inputs the parent wrote and the checks to run; this
rank runs every check and pickles its results to ``<out>/rank<r>.pkl``.
The process group's timeout bounds every collective, so a rank that
diverges fails instead of hanging; the parent bounds the whole run.

Checks (each optional, keyed in the spec):

- ``probe``: the mesh's shape (and the default one), this rank's
  coordinates, ``shard_batch`` of a 5-row batch, this rank's slices of
  ``tree``, that a smaller mesh than the world raises and that a
  weight-only int8 tree is replicated;
- ``verified_load``: a bundle's load through the verified upload;
- ``decode``: ``decode_windows`` on this rank's block of mel rows with the
  tree sharded over ``model``, gathered over ``data``;
- ``train``: two train steps on this rank's rows of one batch;
- ``serving``: ``ServingPipeline(cfg, mesh=...).process`` on one file;
- ``transcribe``: ``WhisperTranscriber.from_config(cfg)`` on one WAV, the
  mesh from ``tpu.mesh_shape``;
- ``batch``: ``BatchDriver(cfg).run(serving=True)`` twice (the second
  resumes) on a directory, with the mesh from ``tpu.mesh_shape``;
- ``pipeline_batch``: the same with ``run()``, ``AudioPipeline`` per file.

The port's backends hold the parent's numpy tree (``tree``) in place of
their own random weights, as ``tests/test_torch_batch.py::carried`` does.
"""

import json
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _copy(tree):
    """A deep copy: ``params_from_numpy`` shares f32 host memory, and a train
    step updates its leaves in place."""
    return {k: _copy(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _carry(tree_path: str) -> None:
    """Every backend built from here on loads the parent's tree."""
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import (
        load_params,
        params_from_numpy,
    )
    from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer
    from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend

    tree = load_params(str(Path(tree_path).parent))
    TorchWhisperBackend.real_load = TorchWhisperBackend.load

    def load(self):
        if self.params is not None:
            return
        self.tokenizer = load_tokenizer(None, n_vocab=self.dims.n_vocab)
        self.params = self._shard(params_from_numpy(_copy(tree), self.device, torch.float32))
        self._maybe_quantize()
        self.temperature_fallback = False  # random weights, as the JAX backend's load

    TorchWhisperBackend.load = load


def probe(mesh, spec, tree) -> dict:
    from modular_audio_pipeline_tpu_torch.config import TPUConfig
    from modular_audio_pipeline_tpu_torch.exceptions import ShardingError
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
    from modular_audio_pipeline_tpu_torch.ops.quant import quantize_decoder
    from modular_audio_pipeline_tpu_torch.parallel.mesh import (
        axis_rank,
        build_mesh,
        data_sharding,
        mesh_shape,
        replicated,
        shard_batch,
    )
    from modular_audio_pipeline_tpu_torch.parallel.sharding import (
        batch_spec,
        model_group,
        shard_params,
    )
    from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend

    dims = WHISPER_DIMS["test-tiny"]
    whole = params_from_numpy(_copy(tree), "cpu", torch.float32)
    placed = shard_params(whole, mesh, dims=dims)
    attn = placed["decoder"]["blocks"]["attn"]
    try:
        build_mesh(TPUConfig(mesh_shape={"data": 2}), "cpu")
        smaller_raises = False
    except ShardingError:
        smaller_raises = True
    try:
        shard_params(quantize_decoder(whole), mesh, dims=dims)
        int8_raises = False
    except ShardingError:
        int8_raises = True
    int8 = TorchWhisperBackend("test-tiny", device="cpu", mesh=mesh, compute_dtype="int8")
    int8.load()
    return {
        "shape": mesh_shape(mesh),
        "placements": [repr(f(mesh)) for f in (data_sharding, replicated, batch_spec)],
        "default_shape": mesh_shape(build_mesh(TPUConfig(), "cpu")),
        "smaller_raises": smaller_raises,
        "coords": {n: axis_rank(mesh, n) for n in mesh.mesh_dim_names},
        "block": shard_batch(mesh, np.arange(5 * 16, dtype=np.float32).reshape(5, 16)),
        "enc_q_w": placed["encoder"]["blocks"]["attn"]["q_w"].numpy(),
        "q_b": attn["q_b"].numpy(), "o_w": attn["o_w"].numpy(), "o_b": attn["o_b"].numpy(),
        "tok_emb": placed["decoder"]["tok_emb"].numpy(),
        "conv1_w": placed["encoder"]["conv1"]["w"].numpy(),
        "int8_raises": int8_raises,
        "int8_sharded": model_group(int8.params) is not None,
        "int8_q_w_shape": tuple(int8.params["encoder"]["blocks"]["attn"]["q_w"].shape),
    }


def verified_load(mesh, spec) -> dict:
    """The bundle load's verified upload, taken on the CUDA branch with the
    upload itself kept on the CPU: what goes up is cast and sliced for
    this rank, and the tensors that come back are the ones the model holds."""
    from modular_audio_pipeline_tpu_torch import transcriber
    from modular_audio_pipeline_tpu_torch.runtime import integrity

    seen = {}

    def spy(tree, device, name="params", retries=3):
        items = list(integrity._leaves(tree))
        seen["dtypes"] = sorted({str(v.dtype) for _, v in items})
        seen["q_w"] = tuple(tree["decoder"]["blocks"]["attn"]["q_w"].shape)
        out = integrity.put_verified_tree(tree, "cpu", name, retries)
        seen["ids"] = [id(v) for _, v in integrity._leaves(out)]
        return out

    transcriber.put_verified_tree = spy
    backend = transcriber.TorchWhisperBackend(spec["model"], device="cpu", mesh=mesh,
                                              weights_path=spec["bundle"])
    backend.device = torch.device("cuda")  # the branch a card takes
    getattr(backend, "real_load", backend.load)()
    held = [id(v) for _, v in integrity._leaves(backend.params)]
    return dict(seen, held_is_verified=held == seen["ids"], uploads=integrity.counts["upload"])


def decode(mesh, spec, tree) -> dict:
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
    from modular_audio_pipeline_tpu_torch.models.whisper.decode import (
        DecodeOptions,
        decode_windows,
    )
    from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer
    from modular_audio_pipeline_tpu_torch.parallel.sharding import shard_params
    from modular_audio_pipeline_tpu_torch.transcriber import TorchWhisperBackend

    dims = WHISPER_DIMS["test-tiny"]
    params = shard_params(params_from_numpy(_copy(tree), "cpu", torch.float32), mesh, dims=dims)
    backend = TorchWhisperBackend("test-tiny", device="cpu", mesh=mesh)  # its DP helpers
    mel = torch.from_numpy(np.load(spec["mel"]))
    local, lo = backend._local_rows(mel)
    opts = DecodeOptions(**spec["opts"])
    res = decode_windows(params, dims, load_tokenizer(None, n_vocab=dims.n_vocab), local, opts)
    full = backend._gather_rows(res)
    return {"lo": lo, "local_tokens": res.tokens, "tokens": full.tokens,
            "sum_logprobs": full.sum_logprobs, "no_speech_probs": full.no_speech_probs}


def train(mesh, spec, tree) -> dict:
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
    from modular_audio_pipeline_tpu_torch.parallel.sharding import shard_params, unshard_params
    from modular_audio_pipeline_tpu_torch.training.train import local_batch, pad_batch
    from modular_audio_pipeline_tpu_torch.training.whisper_train import make_train_step

    dims = WHISPER_DIMS["test-tiny"]
    params = shard_params(params_from_numpy(_copy(tree), "cpu", torch.float32), mesh, dims=dims)
    init_state, step = make_train_step(dims, mesh=mesh)
    state = init_state(params)
    batch = pad_batch(*(np.load(spec[k]) for k in ("mel", "tokens", "targets")),
                      mesh["data"].size() if "data" in mesh.mesh_dim_names else 1)
    mel, tokens, targets = local_batch(batch, mesh)
    args = (torch.from_numpy(mel), torch.from_numpy(tokens).long(),
            torch.from_numpy(targets).long())
    state, loss1 = step(state, *args)
    state, loss2 = step(state, *args)
    whole = unshard_params(state.params)
    return {"loss1": float(loss1), "loss2": float(loss2), "step": state.step,
            "q_w_after": whole["decoder"]["blocks"]["attn"]["q_w"].detach().numpy()}


def serving(mesh, spec) -> dict:
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.serving import ServingPipeline

    cfg = PipelineConfig.from_dict(json.loads(Path(spec["config"]).read_text()))
    pipe = ServingPipeline(cfg, device="cpu", mesh=mesh)
    out = pipe.process(np.load(spec["audio"]), 16000)
    return {"segments": out["segments"], "diarization": out["diarization"],
            "timestamp_mappings": [tuple(vars(m).values()) for m in out["timestamp_mappings"]],
            "decode_stats": out["decode_stats"]}


def transcribe(spec) -> dict:
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    cfg = PipelineConfig.from_dict(json.loads(Path(spec["config"]).read_text()))
    tr = WhisperTranscriber.from_config(cfg, device="cpu")  # its mesh from tpu.mesh_shape
    out = tr.transcribe(spec["wav"])
    return {"segments": out["segments"], "windows": tr._backend.last_stats["windows"]}


def batch(spec) -> dict:
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.parallel.batch import BatchDriver

    cfg = PipelineConfig.from_dict(json.loads(Path(spec["config"]).read_text()))
    serving = spec.get("serving", True)
    first = BatchDriver(cfg, device="cpu").run(serving=serving)
    again = BatchDriver(cfg, device="cpu").run(serving=serving)
    return {"first": first, "again": again}


def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    from modular_audio_pipeline_tpu_torch.config import TPUConfig
    from modular_audio_pipeline_tpu_torch.parallel.mesh import build_mesh

    spec = json.loads(Path(spec_path).read_text())
    mesh = build_mesh(TPUConfig(mesh_shape=spec["mesh"]), "cpu", init_method=spec["store"],
                      rank=rank, world_size=spec["world"], timeout_s=spec["timeout_s"])
    if "tree" in spec:
        _carry(spec["tree"])
        from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params

        tree = load_params(str(Path(spec["tree"]).parent))
    out = {}
    if "probe" in spec:
        out["probe"] = probe(mesh, spec["probe"], tree)
    if "verified_load" in spec:
        out["verified_load"] = verified_load(mesh, spec["verified_load"])
    if "decode" in spec:
        out["decode"] = decode(mesh, spec["decode"], tree)
    if "train" in spec:
        out["train"] = train(mesh, spec["train"], tree)
    if "serving" in spec:
        out["serving"] = serving(mesh, spec["serving"])
    if "transcribe" in spec:
        out["transcribe"] = transcribe(spec["transcribe"])
    if "batch" in spec:
        out["batch"] = batch(spec["batch"])
    if "pipeline_batch" in spec:
        out["pipeline_batch"] = batch(dict(spec["pipeline_batch"], serving=False))
    out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                              or m.split(".")[0] == "modular_audio_pipeline_tpu"
                              for m in sys.modules)
    with open(Path(spec["out"]) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))


def spawn_world(spec: dict, out_dir: Path, deadline_s: float = 120.0) -> list:
    """Start ``spec["world"]`` ranks of this script and wait for them: the
    per-rank results in rank order. The world rendezvouses through a
    ``file://`` store in ``out_dir``; a rank still running at the deadline
    is killed and the call fails, as does a rank that exits non-zero."""
    import os
    import subprocess
    import time

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, out=str(out_dir), store=f"file://{out_dir / 'store'}")
    spec.setdefault("timeout_s", 45.0)
    spec_path = out_dir / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    procs = []
    for r in range(spec["world"]):
        log = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, str(spec_path), str(r)],
                                       stdout=log, stderr=subprocess.STDOUT, env=env), log))
    end = time.monotonic() + deadline_s
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [r for r, (p, _) in enumerate(procs) if p.poll() is None]
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = {r: (out_dir / f"rank{r}.log").read_text()[-3000:] for r in range(len(procs))}
    if late:
        raise AssertionError(f"ranks {late} outlived the {deadline_s} s deadline: {logs}")
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} failed: {logs}")
    out = []
    for r in range(len(procs)):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out

"""Traffic kind "train_steps": the port's Whisper fine-tuning step
(``training.whisper_train.make_train_step``, AdamW at ``train.py``'s
defaults) driven over a pool of synthetic batches.

Set-up makes the weights in the configuration's training type
(``weights.py``), binds the program's train step to them, makes the pool
of batches (``synth.training_batches``; their log-mel through the port's
``ops.mel.log_mel``, as its ``TranscriptDataset`` feeds the step) and
drives that one train state through its first three steps, one batch each:
the steps the reference follows. From that state it reads the first
gradient (Adam's first moment after one step over ``1 - b1``) and, after
the third step, each leaf's change from the start. The window then keeps
stepping through the pool in turn for ``--seconds`` and writes no
checkpoint: ``train_samples_s`` is every sample over all the window's
time, and ``memory_peak_gib`` the allocator's peak over the window.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from .. import roofline, synth
from ..reference import train as ref_train
from ..reference import whisper as ref
from ..trace import Spans, profile
from ..weights import leaves, make_weights

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CHECKED_STEPS = 3


def _program(cfg, traffic, tree):
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.training.optim import adamw
    from modular_audio_pipeline_tpu_torch.training.whisper_train import make_train_step

    o = traffic["optimizer"]
    dims = WHISPER_DIMS[cfg["port_model"]]
    init_state, train_step = make_train_step(
        dims, optimizer=adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                              weight_decay=o["weight_decay"]))
    return init_state(tree), train_step


def _feed(cfg, traffic, seed, device):
    from modular_audio_pipeline_tpu_torch.ops.mel import log_mel

    st = cfg["special_tokens"]
    sot = list(st["sot_sequence"]) + [st["no_timestamps"]]
    raw = synth.training_batches(traffic, seed, st["eot"], sot, st["eot"])
    feed = []
    for b in raw:
        audio = torch.from_numpy(b["audio"]).to(device)
        feed.append({"audio": audio,
                     "mel": log_mel(audio, n_mels=cfg["num_mel_bins"]),
                     "tokens": torch.from_numpy(b["tokens"]).to(device),
                     "targets": torch.from_numpy(b["targets"]).to(device)})
    return feed


def run(cell: Dict[str, Any], seed: int, seconds: float, traced: bool, device: str,
        t_start: float, faults=None, control: bool = False) -> Dict[str, Any]:
    """One run of the cell: set-up, the window, the check. ``faults(step)``
    wraps the program's train step in a fault (``faults.py``); ``control``
    also checks the control in the program's place (``out
    ["control_checks"]``: the reference's steps with TF32 products) and
    the reference with the loss over half of each batch (``out
    ["fault_checks"]["half_batch_reference"]``)."""
    cfg, traffic = cell["config"], cell["traffic"]
    dtype = _DTYPES[cfg["train"]["dtype"]]
    cuda = torch.device(device).type == "cuda"
    tree = make_weights(cfg, dtype, device)
    state, train_step = _program(cfg, traffic, tree)
    if faults:
        train_step = faults(train_step)
    feed = _feed(cfg, traffic, seed, device)
    names = [n for n, _ in leaves(tree)]
    flash_calls: List = []
    restore = _record_flash(flash_calls)
    b1 = traffic["optimizer"]["b1"]

    # the checked steps, through the window's own call and feed
    losses, g1 = [], {}
    for i in range(CHECKED_STEPS):
        b = feed[i]
        state, loss = train_step(state, b["mel"], b["tokens"], b["targets"])
        losses.append(float(loss))
        if i == 0:
            g1 = {n: float(m.double().norm()) / (1.0 - b1)
                  for n, m in zip(names, state.opt_state.mu)}
    start = make_weights(cfg, dtype, device)
    change = {n: float((p.detach() - s).double().norm())
              for (n, p), (_, s) in zip(leaves(state.params), leaves(start))}
    del start
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    batch = traffic["generator"]["batch"]
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    steps, i = 0, CHECKED_STEPS
    while time.perf_counter() - t0 < seconds:
        b = feed[i % len(feed)]
        state, loss = train_step(state, b["mel"], b["tokens"], b["targets"])
        steps += 1
        i += 1
        if cuda:
            torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    last_loss = float(loss) if steps else None

    out: Dict[str, Any] = {
        "attempted": steps, "failed": 0 if last_loss is None or last_loss == last_loss else 1,
        "errors": [], "setup_s": setup_s, "memory_peak_bytes": peak,
        "work": [{"steps": steps, "samples": steps * batch, "batch": batch,
                  "seq_len": traffic["generator"]["seq_len"],
                  "mel_frames": int(feed[0]["mel"].shape[-1])}],
        "e2e": {"train_samples_s": steps * batch / window_s if steps else None,
                "memory_peak_gib": peak / 2**30},
    }
    ctx: Dict[str, Any] = {"kind": "train", "config": cfg, "window_s": window_s,
                           "samples": steps * batch, "memory_peak_bytes": peak,
                           "sample_flops": roofline.train_sample_flops(
                               cfg, traffic["generator"]["seq_len"])}
    if traced:
        flash_calls.clear()

        spans = Spans(sync=True)

        def two_steps():
            nonlocal state
            for j in range(2):
                b = feed[(i + j) % len(feed)]
                with spans.span("train_step"):
                    state, _ = train_step(state, b["mel"], b["tokens"], b["targets"])

        ctx["trace"] = out["trace"] = profile(two_steps, spans)
        ctx["flash_calls"] = list(flash_calls)
    restore()
    out["ctx"] = ctx
    program = {"losses": losses, "grad_norms": g1, "change_norms": change}
    del state, train_step
    tree = None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    want = reference_steps(cell, feed, device)
    out["checks"] = check(cell, program, want)
    out["timings"] = {"check_s": round(time.perf_counter() - t_check, 3)}
    if control:
        out["control_checks"] = check(cell, reference_steps(cell, feed, device, prec="tf32"),
                                      want)
        out["fault_checks"] = {"half_batch_reference": check(
            cell, reference_steps(cell, feed, device, half=True), want)}
    return out


def _record_flash(calls: List):
    from modular_audio_pipeline_tpu_torch.models.whisper import model as model_mod

    orig = model_mod.flash_attention

    def f(q, k, v):
        calls.append((tuple(q.shape), str(q.dtype).replace("torch.", "")))
        return orig(q, k, v)

    model_mod.flash_attention = f

    def restore():
        model_mod.flash_attention = orig

    return restore


def reference_steps(cell, feed, device, prec: str = "f32", half: bool = False
                    ) -> Dict[str, Any]:
    """The reference's three steps from the same start on the same batches
    (its own log-mel of the same audio). ``prec`` "tf32" is the control:
    the same steps with TF32 products; ``half`` plants a fault: each
    step's loss is the mean over the first half of its batch."""
    cfg, traffic = cell["config"], cell["traffic"]
    tree = make_weights(cfg, _DTYPES[cfg["train"]["dtype"]], device)
    n = feed[0]["tokens"].shape[0] // 2 if half else None
    batches = [{"mel": ref.log_mel(b["audio"][:n], cfg["num_mel_bins"]),
                "tokens": b["tokens"][:n], "targets": b["targets"][:n]}
               for b in feed[:CHECKED_STEPS]]
    ref.set_exact_f32()
    if prec == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        return ref_train.run_steps(tree, cfg, batches, traffic["optimizer"], "f32")
    finally:
        ref.set_exact_f32()


def compare(program: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, Any]:
    """The three numbers, by the worst step or leaf: the loss gap relative
    to the reference's loss; each leaf's gap of gradient norms and of
    change norms against the larger of that leaf's reference norm and the
    median leaf's. Leaves whose reference gradient is under a thousandth
    of the median leaf's move by round-off alone and are left out."""
    import statistics

    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], want["losses"]))
    g_ref = want["grad_norms"]
    med_g = statistics.median(g_ref.values())
    kept = [n for n, g in g_ref.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(want["change_norms"][n] for n in kept)

    def worst(key, med):
        gaps = {n: abs(program[key][n] - want[key][n]) / max(want[key][n], med) for n in kept}
        n = max(gaps, key=gaps.get)
        return gaps[n], n

    grad, grad_leaf = worst("grad_norms", med_g)
    change, change_leaf = worst("change_norms", med_c)
    return {"loss_gap": loss, "grad_gap": grad, "grad_leaf": grad_leaf, "change_gap": change,
            "change_leaf": change_leaf, "leaves": len(kept), "left_out": len(g_ref) - len(kept)}


def check(cell, program, want) -> List[Dict[str, Any]]:
    """``program``'s three numbers (see :func:`compare`) against the
    reference's steps ``want``, each beside the cell's limit."""
    got = compare(program, want)
    lim = cell["limits"]
    return [
        {"name": "loss_gap", "value": got["loss_gap"], "limit": lim["loss_gap"]},
        {"name": "grad_gap", "value": got["grad_gap"], "limit": lim["grad_gap"],
         "leaf": got["grad_leaf"]},
        {"name": "change_gap", "value": got["change_gap"], "limit": lim["change_gap"],
         "leaf": got["change_leaf"], "leaves": got["leaves"], "left_out": got["left_out"]},
    ]

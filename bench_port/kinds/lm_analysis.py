"""Traffic kind "lm_analysis": one client sends long meeting transcripts, as
token ids, to the port's local LM back to back, at batch 1, as the
pipeline's LLM stage analyses one recording after another.

Set-up makes the weights (``lm_weights.py``), builds the program's LM
(``models/lm/deepseek_v2.DeepseekV2LM``, the class ``LocalLMAnalyzer``
builds for this model's name) on them, makes the pool of prompts from
``--seed`` (a BOS, then ids drawn uniformly from the traffic's range) and
runs one warm request. The window then calls the LM's ``generate`` on the
pool's prompts in turn, greedy, with no stop id, so that every answer has
the traffic's length, until ``--seconds`` have passed, and lets the last
request finish: ``audio_x`` is the meeting seconds that the completed
requests' transcripts stand for over the time from the window's start to
the last completion.

The benchmark wraps three functions of the program's module that
``generate`` looks up at call time: ``forward`` (the prefill: for one
request drawn from the seed it keeps the last position's logits and the
latent cache), ``_decode`` (each decode step: it counts them, and for
that request keeps each step's logits) and ``_route`` (that request's
chosen experts in the prefill; the decode steps' routing runs inside the
captured graph). That request is checked after the window (:func:`check`).
In a traced run every window request runs under the port's own recorder
(``runtime/tracing.record``: spans ``lm.generate``, ``lm.prefill``,
``lm.decode``, counter ``lm.decode_steps``), and one more request runs
under the profiler.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import roofline_lm
from ..lm_weights import make_weights
from ..reference import deepseek_v2 as ref
from ..trace import Spans, profile

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def prompts(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int) -> List[np.ndarray]:
    """The pool of prompts: each a BOS, then ids drawn uniformly from the
    traffic's ``id_range`` (a generator seeded from ``seed``)."""
    g = traffic["generator"]
    rng = np.random.default_rng([seed, 1818])
    lo, hi = g["id_range"]
    pool = []
    for _ in range(g["pool"]):
        ids = rng.integers(lo, hi, g["prompt_tokens"], dtype=np.int64)
        ids[0] = cfg["bos_token_id"]
        pool.append(ids)
    return pool


class Probe:
    """The wrappers around ``generate``'s calls into the program's module."""

    def __init__(self, ds):
        self.ds = ds
        self.keep = False  # keep this request's logits, cache and routes
        self.rec: Dict[str, Any] = {}
        self.steps = 0
        self._restore: List = []

        self._prefill = False

        def forward(orig):
            def f(params, cfg, tokens, cache, *a, **kw):
                self._prefill = self.keep and tokens.shape[1] > 1
                try:
                    logits, cache = orig(params, cfg, tokens, cache, *a, **kw)
                finally:
                    self._prefill = False
                if self.keep and tokens.shape[1] > 1:
                    self.rec["cache"] = cache
                    self.rec["rows"] = [logits[0, -1].clone()]
                return logits, cache
            return f

        def decode(orig):
            def f(*a):
                logits = orig(*a)
                self.steps += 1
                if self.keep:
                    self.rec["rows"].append(logits[0, -1].clone())
                return logits
            return f

        def route(orig):
            def f(h, w, cfg):
                idx, weights = orig(h, w, cfg)
                if self._prefill:
                    self.rec.setdefault("routes", []).append(
                        idx.sort(dim=-1).values.to(torch.int16))
                return idx, weights
            return f

        self.patch(ds, "forward", forward)
        self.patch(ds, "_decode", decode)
        self.patch(ds, "_route", route)

    def patch(self, obj, name, make):
        """``obj.name = make(obj.name)`` until :meth:`restore`."""
        orig = getattr(obj, name)
        self._restore.append((obj, name, orig))
        setattr(obj, name, make(orig))

    def restore(self) -> None:
        for obj, name, orig in reversed(self._restore):
            setattr(obj, name, orig)
        self._restore = []


def expert_dropped(probe) -> None:
    """Each token's sixth routed expert left out (top-5)."""
    def make(orig):
        def route(h, w, cfg):
            idx, weights = orig(h, w, cfg)
            return idx, torch.cat([weights[:, :-1], torch.zeros_like(weights[:, -1:])], dim=1)
        return route

    probe.patch(probe.ds, "_route", make)


def shared_expert_dropped(probe) -> None:
    """The shared experts add nothing."""
    probe.patch(probe.ds, "_shared_expert", lambda orig: lambda h, p: torch.zeros_like(h))


def yarn_off(probe) -> None:
    """Plain RoPE frequencies and no YaRN scale on the softmax."""
    def inv_freq(orig):
        def f(cfg, device="cpu"):
            d = cfg.qk_rope_dim
            expo = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
            return 1.0 / cfg.rope_theta ** expo, 1.0
        return f

    probe.patch(probe.ds, "yarn_inv_freq", inv_freq)
    probe.patch(probe.ds, "softmax_scale", lambda orig: lambda cfg: cfg.qk_head_dim ** -0.5)


def latent_rope_dropped(probe) -> None:
    """The shared RoPE key ``k_pe`` is not written to the latent cache."""
    def make(orig):
        def write(cache, layer, pos, c_kv, k_pe):
            cache.c_kv[layer].index_copy_(1, pos, c_kv)
        return write

    probe.patch(probe.ds, "_write_latent", make)


FAULTS = {f.__name__: f for f in (expert_dropped, shared_expert_dropped, yarn_off,
                                  latent_rope_dropped)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Dict[str, Any], seed: int, seconds: float, traced: bool, device: str,
        t_start: float, faults=None, control: bool = False) -> Dict[str, Any]:
    """One run of the cell: set-up, the window, the check. ``faults(probe)``
    plants a fault in the program (this module's ``FAULTS``); ``control``
    also checks the control in the program's place (``out
    ["control_checks"]``: the reference's products in fp8)."""
    from modular_audio_pipeline_tpu_torch.models.lm import deepseek_v2 as ds

    cfg, traffic = cell["config"], cell["traffic"]
    marks = [("start", time.perf_counter())]
    tree = make_weights(cfg, _DTYPES[cfg["serve"]["dtype"]], device)
    marks.append(("weights", time.perf_counter()))
    pool = prompts(cfg, traffic, seed)
    lm = ds.DeepseekV2LM(ds.DEEPSEEK_V2_CONFIGS[cfg["port_model"]], params=tree, device=device)
    probe = Probe(ds)
    if faults:
        faults(probe)
    try:
        return _run(cell, seed, seconds, traced, device, t_start, lm, probe, tree, pool, marks,
                    control)
    finally:
        probe.restore()


def _run(cell, seed, seconds, traced, device, t_start, lm, probe, tree, pool, marks, control):
    from modular_audio_pipeline_tpu_torch.runtime import tracing

    cfg, traffic = cell["config"], cell["traffic"]
    g = traffic["generator"]
    new = g["answer_tokens"]
    cuda = torch.device(device).type == "cuda"
    attempted, failed, errors, works, req_s, recs = 0, 0, [], [], [], []

    def request(prompt):
        return lm.generate(prompt, max_new_tokens=new, temperature=0.0, eos_id=None)

    try:  # warm-up: one request, the cell's shapes
        request(pool[0])
        _sync(device)
    except Exception as exc:  # the path is broken: no window, not correct
        attempted, failed = 1, 1
        errors.append(repr(exc))
    marks.append(("warm request", time.perf_counter()))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pick = np.random.default_rng([seed, 7])
    kept = None  # (request index, prompt, answer, what the probe kept)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    t_last = t0
    i = 0
    while not failed and time.perf_counter() - t0 < seconds:
        probe.keep = pick.random() < 1.0 / (i + 1)
        probe.rec, probe.steps = {}, 0
        prompt = pool[i % len(pool)]
        attempted += 1
        t_req = time.perf_counter()
        try:
            if traced:
                with tracing.record() as rec:
                    answer = request(prompt)
                recs.append(rec.summary())
            else:
                answer = request(prompt)
            _sync(device)
        except Exception as exc:  # a failed request is counted and ends the window
            failed += 1
            errors.append(repr(exc))
            break
        t_last = time.perf_counter()
        req_s.append(t_last - t_req)
        works.append({"prompt_tokens": int(len(prompt)), "answer_tokens": int(len(answer)),
                      "decode_steps": probe.steps})
        if probe.keep:
            kept = (i, prompt, answer, probe.rec)
        i += 1
    probe.keep = False
    window_s = t_last - t0
    done = len(req_s)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out: Dict[str, Any] = {
        "attempted": attempted, "failed": failed, "errors": errors, "setup_s": setup_s,
        "memory_peak_bytes": peak, "work": works,
        "timings": {"setup": {b[0]: round(b[1] - a[1], 3) for a, b in zip(marks, marks[1:])},
                    "request_s": [round(x, 3) for x in req_s]},
    }
    out["e2e"] = {"audio_x": done * g["meeting_s"] / window_s if done else None}
    ctx: Dict[str, Any] = {"kind": "lm", "config": cfg, "window_s": window_s, "requests": done,
                           "memory_peak_bytes": peak, "work": works,
                           "request_flops": [roofline_lm.request_flops(
                               cfg, w["prompt_tokens"], w["answer_tokens"]) for w in works]}
    if traced and done:
        ctx.update(_span_readings(cfg, works, recs))
        spans = Spans(sync=False)

        def profiled():
            with tracing.record() as rec:
                request(pool[0])
            spans.events.extend((s.name, s.start_ns, s.end_ns) for s in rec.spans)

        ctx["trace"] = out["trace"] = profile(profiled, spans)
    out["ctx"] = ctx
    del lm
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    program = outputs(cfg, kept) if kept else None
    want = reference(cell, tree, program, "f32") if program else None
    out["checks"] = check(cell, works, failed, kept, program, want)
    out["timings"]["check_s"] = round(time.perf_counter() - t_check, 3)
    if control and program:
        low = reference(cell, tree, program, "fp8")
        out["control_checks"] = check(cell, works, failed, kept,
                                      dict(program, rows=low["rows"], c_kv=low["c_kv"],
                                           k_pe=low["k_pe"], routes=low["routes"]), want)
    return out


def _span_readings(cfg, works, recs) -> Dict[str, Any]:
    """Per request: the device seconds of ``lm.prefill`` and of ``lm.decode``
    and the decode steps counted, and the bytes each step must read."""
    prefill, decode, steps, step_bytes = [], [], [], 0.0
    for w, s in zip(works, recs):
        if s.get("lm.prefill", {}).get("device_s") is None or "lm.decode" not in s:
            continue
        prefill.append(s["lm.prefill"]["device_s"])
        decode.append(s["lm.decode"]["device_s"])
        n = s["lm.decode"]["counts"].get("lm.decode_steps", 0)
        steps.append(n)
        step_bytes += sum(roofline_lm.decode_step_bytes(cfg, w["prompt_tokens"] + j + 1)
                          for j in range(n))
    return {"prefill_s": prefill, "decode_s": decode, "decode_steps": steps,
            "decode_bytes": step_bytes}


def outputs(cfg, kept) -> Dict[str, Any]:
    """What the program produced for the kept request: its prompt and
    answer ids, the last-position logits of the prefill and of each decode
    step ``[answer, V]`` (f32), the latent cache at the prompt's positions
    (``c_kv [L, P, R]``, ``k_pe [L, P, rope]``) and each MoE layer's chosen
    experts at the prompt's positions ``[Lm, P, k]``."""
    i, prompt, answer, rec = kept
    p = len(prompt)
    cache = rec["cache"]
    routes = rec.get("routes")
    return {"request": i, "prompt": prompt, "answer": [int(t) for t in answer],
            "rows": torch.stack(rec["rows"]).float(),
            "c_kv": cache.c_kv[:, 0, :p].float(), "k_pe": cache.k_pe[:, 0, :p].float(),
            "routes": torch.stack(routes) if routes else None}


def reference(cell, tree, program, prec: str) -> Dict[str, Any]:
    """The plain reference over the kept request's prompt and answer (all
    but its last token, which no forward reads), its products in ``prec``:
    the logits where the program read them, the latent cache at the
    prompt's positions and the chosen experts."""
    cfg = cell["config"]
    p, a = len(program["prompt"]), program["answer"]
    dev = program["rows"].device
    seq = torch.as_tensor(np.concatenate([program["prompt"], np.asarray(a[:-1], np.int64)]),
                          device=dev)
    got = ref.forward(tree, cfg, seq, p, range(p - 1, p - 1 + len(a)), prec)
    return {"rows": got["logits"], "c_kv": got["c_kv"], "k_pe": got["k_pe"],
            "routes": got["experts"][:, :p]}


def compare(program, want) -> Dict[str, Any]:
    """``logprob_gap``: the widest gap, over the answer's tokens, between
    the program's log-probability of its own token and the reference's;
    ``prefill_logit_gap``: the widest gap of the last prompt position's
    log-softmax; ``latent_cache_gap``: over layers, the larger of the
    relative gaps (Frobenius norm of the difference over the reference's)
    of ``c_kv`` and of ``k_pe`` at the prompt's positions;
    ``routes_differ``: the share of (MoE layer, prompt position) whose
    chosen set of experts is not the reference's."""
    lp, lr = torch.log_softmax(program["rows"], -1), torch.log_softmax(want["rows"], -1)
    tok = torch.as_tensor(program["answer"], device=lp.device)[:, None]
    gaps = (lp.gather(1, tok) - lr.gather(1, tok)).abs()[:, 0]
    latent = max(float(((program[k][layer] - want[k][layer]).norm()
                         / want[k][layer].norm().clamp(min=1e-30)))
                 for k in ("c_kv", "k_pe") for layer in range(want[k].shape[0]))
    routes = None
    if program.get("routes") is not None and program["routes"].shape == want["routes"].shape:
        routes = float((program["routes"] != want["routes"]).any(-1).float().mean())
    return {"logprob_gap": float(gaps.max()), "widest_token": int(gaps.argmax()),
            "prefill_logit_gap": float((lp[0] - lr[0]).abs().max()),
            "latent_cache_gap": latent, "routes_differ": routes}


def check(cell, works, failed, kept, program, want) -> List[Dict[str, Any]]:
    """The numbers ``correct`` is decided by, each beside its limit: every
    request's answer has the traffic's length; for one request drawn from
    the seed (a reservoir sample over the window's requests), ``program``
    against the plain reference (:func:`compare`). ``routes_differ`` is
    printed beside ``logprob_gap``, not compared: a near tie of two
    experts' scores flips with the rounding."""
    lim = cell["limits"]
    new = cell["traffic"]["generator"]["answer_tokens"]
    checks = [{"name": "failed_requests", "value": failed, "limit": 0}]
    bad = [w["answer_tokens"] for w in works if w["answer_tokens"] != new]
    checks.append({"name": "answers_off_length", "value": len(bad), "limit": 0, "expect": new,
                   "seen": sorted({w["answer_tokens"] for w in works})})
    checks.append({"name": "requests_unchecked", "value": int(program is None), "limit": 0})
    if program is None:
        return checks
    got = compare(program, want)
    checks += [
        {"name": "logprob_gap", "value": got["logprob_gap"], "limit": lim["logprob_gap"],
         "request": kept[0], "widest_token": got["widest_token"],
         "routes_differ": got["routes_differ"]},
        {"name": "prefill_logit_gap", "value": got["prefill_logit_gap"],
         "limit": lim["prefill_logit_gap"]},
        {"name": "latent_cache_gap", "value": got["latent_cache_gap"],
         "limit": lim["latent_cache_gap"]},
    ]
    return checks

"""Traffic kind "serve_closed_loop": one client sends whole recordings to
``ServingPipeline.process`` back to back.

Set-up builds the pipeline from the configuration and the traffic's
settings, hands it the benchmark's weights (``weights.py``), makes the
pool of recordings (``synth.py``) and runs one warm request. The window
then sends the pool's recordings in turn until ``--seconds`` have passed,
and lets the last request finish: ``audio_x`` is the audio seconds of
every request over the time from the window's start to the last
completion.

The benchmark wraps the calls that ``process`` makes into the port's
layers (module attributes that ``process`` looks up at call time, and
methods of the pipeline and its backend): the wrappers count decode
steps and batch rows in every run, keep what one request produced at
each stage (its gathered windows, decode results, keep intervals and
word lists), and, in a traced run, time each layer as a span that waits
for the card at its end (``trace.Spans``). That request is checked after
the window (see :func:`check`).
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from .. import roofline, synth
from ..reference import diarization as ref_diar
from ..reference import layout as ref_layout
from ..reference import segmentation as ref_seg
from ..reference import whisper as ref
from ..reference import words as ref_words
from ..trace import Spans, profile, sync
from ..weights import make_weights

SR = 16000
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_pipeline(cfg: Dict[str, Any], traffic: Dict[str, Any], tree, device):
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer
    from modular_audio_pipeline_tpu_torch.serving import ServingPipeline

    d = traffic["decode"]
    pcfg = PipelineConfig(lazy_load_models=False)
    t = pcfg.transcription
    t.model, t.language, t.weights_path = cfg["port_model"], d["language"], "random:0"
    t.compute_type = cfg["serve"]["dtype"]
    t.beam_size, t.max_decode_tokens, t.batch_size = d["beam_size"], d["max_tokens"], d["batch_size"]
    t.kv_cache_dtype, t.word_timestamps = cfg["serve"]["kv_cache_dtype"], d["word_timestamps"]
    t.no_speech_threshold = None  # every kept window is decoded and aligned
    pcfg.diarization.enabled = traffic["stages"]["diarization"]
    pcfg.diarization.min_speakers = traffic["stages"]["min_speakers"]
    pcfg.diarization.max_speakers = traffic["stages"]["max_speakers"]
    pcfg.vocal_separation.enabled = traffic["stages"]["separation"]
    pipe = ServingPipeline(pcfg, device=device)
    b = pipe.backend
    # the benchmark's weights in place of the backend's own random ones
    b.params = tree
    b.tokenizer = load_tokenizer(None, n_vocab=cfg["vocab_size"])
    b.temperature_fallback = False
    return pipe


class Probe:
    """The wrappers around ``process``'s calls into the port's layers."""

    def __init__(self, pipe, spans: Spans):
        from modular_audio_pipeline_tpu_torch.models.diarization import segmentation as seg_mod
        from modular_audio_pipeline_tpu_torch.models.diarization.segmentation import (
            SegmentationNet)
        from modular_audio_pipeline_tpu_torch.models.whisper import decode as dec_mod
        from modular_audio_pipeline_tpu_torch.models.whisper import model as model_mod
        from modular_audio_pipeline_tpu_torch.ops import mel as mel_mod
        from modular_audio_pipeline_tpu_torch import serving as serving_mod
        from modular_audio_pipeline_tpu_torch import transcriber as tr_mod
        from modular_audio_pipeline_tpu_torch.models.whisper import timestamps as ts_mod

        self.spans = spans
        self.request: Dict[str, Any] = {}
        self.keep = False  # keep this request's windows for the check
        self.record_kernels = False  # record kernel arguments (the profiled request)
        self.flash_calls: List = []
        self.anc_launches: List[tuple] = []  # (launch shape, its selected rows on the card)
        self._anc_seen: Dict[int, torch.Tensor] = {}
        self._restore = []
        self._jobs: Dict[int, int] = {}  # the alignment batch's rows -> window index
        self._cols: List[np.ndarray] = []  # the DTW's entry columns, item by item
        patch = self.patch

        def log_mel(orig):
            def f(audio, *a, **kw):
                r = self.request
                if "t_whisper" not in r and spans.sync:
                    sync()
                    r["t_whisper"] = time.perf_counter()
                r["rows"] = r.get("rows", 0) + audio.shape[0]
                if self.keep:
                    r.setdefault("windows", []).append(audio.detach().clone())
                with spans.span("whisper.log_mel"):
                    return orig(audio, *a, **kw)
            return f

        def decode_pending(orig):
            def f(*a, **kw):
                if spans.sync:
                    sync()
                    self.request["t_decode"] = time.perf_counter()
                with spans.span("whisper.decode"):
                    return orig(*a, **kw)
            return f

        def spanned(label):
            def make(orig):
                def f(*a, **kw):
                    with spans.span(label):
                        return orig(*a, **kw)
                return f
            return make

        def finalize(orig):
            def f(pending):
                with spans.span("whisper.fetch"):
                    res = orig(pending)
                r = self.request
                r.setdefault("results", []).append(res)
                if spans.sync:
                    now = time.perf_counter()
                    spans.seconds["decode"].append(now - r.pop("t_decode"))
                    r["t_whisper_end"] = now
                return res
            return f

        def decoder_forward(orig):
            def f(params, dims, tokens, *a, **kw):
                key = "decode_steps" if tokens.shape[1] == 1 else "prefills"
                self.request[key] = self.request.get(key, 0) + 1
                return orig(params, dims, tokens, *a, **kw)
            return f

        def words(orig):
            def f(jobs, *a, **kw):
                self._jobs = {idx: int(round(offset / 30.0)) for _, _, idx, offset in jobs}
                with spans.span("whisper.words"):
                    out = orig(jobs, *a, **kw)
                if spans.sync:
                    self.request["t_whisper_end"] = time.perf_counter()
                return out
            return f

        def aligned(orig):
            def f(params, dims, tok, xa_k, xa_v, items, *a, **kw):
                self._cols = []
                out = orig(params, dims, tok, xa_k, xa_v, items, *a, **kw)
                if self.keep:
                    got = self.request.setdefault("aligned", {})
                    for (idx, _, _), w, c in zip(items, out, self._cols):
                        got[self._jobs.get(idx, idx)] = (w, c)
                return out
            return f

        def words_from_cols(orig):
            def f(cols, tokens, prefix, tokenizer):
                if self.keep:
                    n = sum(int(t) != tokenizer.eot for t in tokens)
                    self._cols.append(np.asarray(cols[:n]).astype(np.int64))
                return orig(cols, tokens, prefix, tokenizer)
            return f

        def marginals(orig):
            def f(net, mel):
                out = orig(net, mel)
                if self.keep:
                    self.request.setdefault("activity", []).append(out.detach())
                return out
            return f

        def keep_intervals(orig):
            def f(*a, **kw):
                with spans.span("serving.vad"):
                    out = orig(*a, **kw)
                if self.keep:
                    self.request["keep"] = [(int(s), int(e)) for s, e in out[0]]
                return out
            return f


        def flash(orig):
            def f(q, k, v):
                if self.record_kernels:
                    self.flash_calls.append((tuple(q.shape), str(q.dtype).replace("torch.", "")))
                return orig(q, k, v)
            return f

        def ancestry(orig):
            def f(q, ck, cv, ks, vs, layer, anc, mask_row, **kw):
                if self.record_kernels:
                    self._anc_launch(q, ck, ks, anc, mask_row)
                return orig(q, ck, cv, ks, vs, layer, anc, mask_row, **kw)
            return f

        patch(serving_mod, "_dsp_stats", spanned("serving.dsp"))
        patch(pipe, "_keep_intervals", keep_intervals)
        patch(dec_mod, "encode_audio_kv", spanned("whisper.encode"))
        patch(mel_mod, "log_mel", log_mel)
        patch(dec_mod, "_decode_pending", decode_pending)
        patch(dec_mod, "finalize_decode", finalize)
        patch(dec_mod, "decoder_forward", decoder_forward)
        patch(model_mod, "flash_attention", flash)
        patch(seg_mod, "flash_attention", flash)
        patch(model_mod, "ancestor_attention", ancestry)
        patch(pipe.backend, "_attach_words_batch", words)
        patch(tr_mod, "align_words_batched", aligned)
        patch(ts_mod, "_words_from_cols", words_from_cols)
        patch(pipe, "_diarize_windows", spanned("diarization"))
        patch(SegmentationNet, "marginals", marginals)

    def patch(self, obj, name, make):
        """``obj.name = make(obj.name)`` until :meth:`restore`."""
        orig = getattr(obj, name)
        self._restore.append((obj, name, orig))
        setattr(obj, name, make(orig))

    def _anc_launch(self, q, ck, ks, anc, mask_row):
        """Records a launch: its shapes and, counted on the card once per
        step, the distinct (beam row, position) pairs that the hypotheses
        select at the live positions (read back after the request)."""
        rows = self._anc_seen.get(id(anc))
        if rows is None:
            live = (mask_row == 0)
            srt = torch.sort(anc, dim=1).values
            distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1)  # [BW, ctx]
            rows = (distinct * live[None, :]).sum()
            self._anc_seen = {id(anc): rows}
        self.anc_launches.append(((tuple(q.shape), q.element_size(), q.shape[-1],
                                   ck.element_size(), ks is not None, anc.numel(),
                                   mask_row.numel()), rows))

    def anc_bytes(self) -> float:
        """Bytes the recorded launches must move (``roofline.ancestry_bytes``)."""
        if not self.anc_launches:
            return 0.0
        counts = torch.stack([r for _, r in self.anc_launches]).tolist()
        return float(sum(roofline.ancestry_bytes(shape, isz, int(n), hd, csz, sc, an, mn)
                         for ((shape, isz, hd, csz, sc, an, mn), _), n
                         in zip(self.anc_launches, counts)))

    def restore(self) -> None:
        for obj, name, orig in reversed(self._restore):
            if isinstance(obj, type) or not hasattr(type(obj), name):
                setattr(obj, name, orig)
            else:
                delattr(obj, name)  # an instance attribute over the class's method
        self._restore = []


def _work(result: Dict[str, Any], req: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "kept_s": result["kept_duration"],
        "windows": result["decode_stats"]["n_windows"],
        "rows": req.get("rows", 0),
        "decode_steps": req.get("decode_steps", 0),
        "tokens": result["decode_stats"]["tokens_decoded"],
        "segments": len(result["segments"]),
        "words": sum(len(s.get("words", [])) for s in result["segments"]),
        "turns": len(result["diarization"]),
    }


def run(cell: Dict[str, Any], seed: int, seconds: float, traced: bool, device: str,
        t_start: float, faults=None, control: bool = False) -> Dict[str, Any]:
    """One run of the cell: set-up, the window, the check. ``faults(probe,
    pipe)`` plants a fault in the program (``faults.py``); ``control``
    also checks the control in the program's place (``out
    ["control_checks"]``: the reference's products in fp8)."""
    cfg, traffic = cell["config"], cell["traffic"]
    marks = [("start", time.perf_counter())]
    tree = make_weights(cfg, _DTYPES[cfg["serve"]["dtype"]], device)
    marks.append(("weights", time.perf_counter()))
    pool, utts = synth.recordings(traffic, seed)
    marks.append(("recordings", time.perf_counter()))
    audio_s = [len(x) / SR for x in pool]
    pipe = build_pipeline(cfg, traffic, tree, device)
    marks.append(("pipeline", time.perf_counter()))
    spans = Spans(sync=traced)
    probe = Probe(pipe, spans)
    if faults:
        faults(probe, pipe)
    try:
        return _run(cell, seed, seconds, traced, device, t_start, pipe, probe, spans, tree,
                    pool, utts, audio_s, marks, control)
    finally:
        probe.restore()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run(cell, seed, seconds, traced, device, t_start, pipe, probe, spans, tree, pool,
         utts, audio_s, marks, control):
    cfg, traffic = cell["config"], cell["traffic"]
    works, req_s, attempted, failed, errors = [], [], 0, 0, []
    # warm-up: one request, the cell's shapes only
    probe.request = {}
    try:
        pipe.process(pool[0], SR)
        _sync(device)
    except Exception as exc:  # the path is broken: no window, not correct
        attempted, failed = 1, 1
        errors.append(repr(exc))
    marks.append(("warm request", time.perf_counter()))
    for v in spans.seconds.values():
        v.clear()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pick = np.random.default_rng([seed, 7])
    kept = None  # (request index, its record), a reservoir sample of one
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    t_last = t0
    i = 0
    while not failed and time.perf_counter() - t0 < seconds:
        probe.request = {}
        probe.keep = pick.random() < 1.0 / (i + 1)
        attempted += 1
        t_req = time.perf_counter()
        try:
            result = pipe.process(pool[i % len(pool)], SR)
            _sync(device)
        except Exception as exc:  # a failed request is counted and ends the window
            failed += 1
            errors.append(repr(exc))
            break
        t_last = time.perf_counter()
        req_s.append(t_last - t_req)
        rec = probe.request
        works.append(_work(result, rec))
        if traced and "t_whisper" in rec:
            spans.seconds["whisper"].append(rec["t_whisper_end"] - rec["t_whisper"])
        if probe.keep:
            rec["turns"] = result["diarization"]
            kept = (i, rec)
        else:
            rec.pop("results", None)
        i += 1
    window_s = t_last - t0
    done = len(req_s)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out: Dict[str, Any] = {
        "attempted": attempted, "failed": failed, "errors": errors, "setup_s": setup_s,
        "memory_peak_bytes": peak, "work": works,
        "timings": {"setup": {b[0]: round(b[1] - a[1], 3) for a, b in zip(marks, marks[1:])},
                    "request_s": [round(x, 3) for x in req_s]},
    }
    out["e2e"] = {"audio_x": sum(audio_s[j % len(pool)] for j in range(done)) / window_s
                  if done else None}

    probe.keep = False
    ctx: Dict[str, Any] = {"kind": "serve", "spans": {k: list(v) for k, v in spans.seconds.items()},
                           "config": cfg, "work": works,
                           "window_s": window_s, "requests": done,
                           "memory_peak_bytes": peak}
    if traced and done:
        ctx["request_flops"] = [_request_flops(cfg, traffic, w) for w in works]
        probe.record_kernels = True
        probe.request = {}
        def request():
            with spans.span("process"):
                pipe.process(pool[0], SR)

        trace = profile(request, spans)
        probe.record_kernels = False
        ctx["trace"] = trace
        ctx["flash_calls"] = probe.flash_calls
        ctx["anc_bytes"] = probe.anc_bytes()
        ctx["anc_launches"] = len(probe.anc_launches)
        out["trace"] = trace
    out["ctx"] = ctx
    probe.request = {}
    probe.restore()
    del pipe, probe
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    truth = ref_layout.truth_ms(utts, audio_s[0])
    program = outputs(cell, kept[1]) if kept else None
    want = reference(cell, program, tree, "f32") if program else None
    out["checks"] = check(cell, works, failed, kept, program, want, truth)
    out["timings"]["check_s"] = round(time.perf_counter() - t_check, 3)
    if control and program:
        # the reference one step below bf16 in the program's place
        low = reference(cell, program, tree, "fp8")
        low = {k: low[k] for k in ("sums", "cols", "words")}
        out["control_checks"] = check(cell, works, failed, kept, dict(program, **low), want,
                                      truth)
    return out


def _request_flops(cfg, traffic, w) -> float:
    d = traffic["decode"]
    n_align = max(0, w["tokens"] // max(1, w["windows"]))
    return roofline.serve_request_flops(
        cfg, w["windows"], d["beam_size"], len(cfg["special_tokens"]["sot_sequence"]),
        w["decode_steps"], [n_align] * w["windows"] if d["word_timestamps"] else [])


def outputs(cell, rec) -> Dict[str, Any]:
    """What the program produced for a kept request: its real windows'
    audio ``[W, 480000]`` as ``process`` handed them to ``log_mel``, the
    served tokens of each (up to EOT), whether each ended with EOT, the
    summed log-probabilities it reports for them, for each window it
    aligned (by window index) its words and the DTW's entry column of each
    served token, its keep intervals (ms of the recording), the flat kept
    timeline that diarization reads (every window of the bucket), the
    segmentation network's per-speaker activity over its windows and its
    speaker turns."""
    cfg, traffic = cell["config"], cell["traffic"]
    eot = cfg["special_tokens"]["eot"]
    max_tokens = traffic["decode"]["max_tokens"]
    wins, toks, fin, sums = [], [], [], []
    n_real = traffic["expect"]["windows"]
    for rows, res in zip(rec.get("windows", []), rec.get("results", [])):
        for r in range(min(rows.shape[0], len(res.tokens))):
            if len(toks) >= n_real:
                break
            t = [int(x) for x in res.tokens[r]]
            n = t.index(eot) if eot in t else len(t)
            wins.append(rows[r])
            toks.append(t[:n])
            fin.append(n < max_tokens)
            sums.append(float(res.sum_logprobs[r]))
    aligned = rec.get("aligned", {})
    return {"windows": torch.stack(wins) if wins else None, "tokens": toks, "finished": fin,
            "sums": sums, "words": {w: a[0] for w, a in aligned.items()},
            "cols": {w: a[1] for w, a in aligned.items()}, "keep": rec.get("keep", []),
            "kept_ms": sum(e - s for s, e in rec.get("keep", [])),
            "timeline": torch.cat(rec["windows"]).reshape(-1) if rec.get("windows") else None,
            "activity": torch.cat(rec["activity"]) if rec.get("activity") else None,
            "turns": rec.get("turns", [])}


def reference(cell, program, tree, prec: str) -> Dict[str, Any]:
    """The plain reference over the same windows and served tokens, its
    products in ``prec``: the summed log-probabilities, and each window's
    alignment: the DTW's cost matrix, each token's entry column and the
    words they give; and, from the same flat timeline, the segmentation
    network's activity and the speaker turns (in f32, the diarization's
    own type)."""
    if program["windows"] is None:
        return {"sums": [], "costs": {}, "cols": {}, "words": {}, "activity": None,
                "turns": []}
    st = cell["config"]["special_tokens"]
    ref.set_exact_f32()
    sums, costs, cols = ref.served_outputs(tree, cell["config"], program["windows"],
                                           st["sot_sequence"], program["tokens"],
                                           program["finished"], st["eot"], prec)
    words = {w: ref_words.group_words(c, program["tokens"][w], st["eot"])
             for w, c in enumerate(cols)}
    activity, turns = None, []
    timeline = program["timeline"]
    if timeline is not None and prec == "f32" and cell["traffic"]["stages"]["diarization"]:
        bundles = Path(os.environ["MAP_TPU_WEIGHTS"])
        activity = ref_seg.window_activity(timeline, ref_seg.load(
            bundles / "diarization-segmentation" / "params.npz", timeline.device))
        st = cell["traffic"]["stages"]
        turns = ref_diar.diarize(timeline, activity,
                                 min(timeline.shape[0], 16 * program["kept_ms"]), bundles,
                                 st["min_speakers"], st["max_speakers"])
    return {"sums": sums, "costs": dict(enumerate(costs)), "cols": dict(enumerate(cols)),
            "words": words, "activity": activity, "turns": turns}


def alignment(program, want, eot: int) -> Dict[str, Any]:
    """Over the windows the program aligned: ``cost_gap``, by how much the
    program's DTW path costs more than the reference's own under the
    reference's cost matrix, per token, averaged over the windows (the
    path's counterpart of a token's logit gap: on the near-even attention
    of random weights many paths cost about the same, and word times read
    which of them the rounding picked; the widest window's gap, beside it,
    swings from seed to seed); ``off_path``, the windows whose words are
    not the grouping of the program's own path; and, beside them, the
    mean gap in seconds between the program's word starts and ends and
    the reference's."""
    gaps, off, times = [], 0, []
    for w, cols in program["cols"].items():
        toks = program["tokens"][w]
        cost = want["costs"][w].astype(np.float64)
        n = min(len(cols), cost.shape[0])
        if n == 0:
            continue
        gaps.append((ref_words.path_cost(cost[:n], cols[:n])
                     - ref_words.path_cost(cost[:n], want["cols"][w][:n])) / n)
        words = program["words"].get(w, [])
        if words != ref_words.group_words(cols, toks, eot):
            off += 1
        ref_w = want["words"][w]
        if [x["word"] for x in words] == [x["word"] for x in ref_w]:
            for a, b in zip(words, ref_w):
                times += [abs(a["start"] - b["start"]), abs(a["end"] - b["end"])]
    return {"cost_gap": float(np.mean(gaps)) if gaps else float("inf"),
            "cost_gap_widest": max(gaps) if gaps else float("inf"),
            "off_path": off, "windows": len(program["cols"]),
            "word_gap_s": float(np.mean(times)) if times else None}


def check(cell, works, failed, kept, program, want, truth) -> List[Dict[str, Any]]:
    """The numbers ``correct`` is decided by, each beside its limit:

    - every request's layout counts (kept seconds within the traffic's
      range; windows, batch rows and decode steps equal to the traffic's);
    - for one request drawn from the seed (a reservoir sample over the
      window's requests), ``program`` against the plain reference
      (``want``, from the same window audio: the program's gathered
      windows, see ``PERF.md``) and against the recording's truth:
      ``logprob_gap``, the widest gap per served token between the summed
      log-probabilities of each window's served tokens;
      ``align_cost_gap`` and ``words_off_path`` (:func:`alignment`);
      ``speech_missed``, the share of the utterances that the keep
      intervals leave out (beside it, the seconds of silence they keep);
      ``turns_gap``, the share of the kept timeline where the speaker
      turns disagree with the reference's over the same timeline (beside
      it, ``speaker_error`` against the recording's voices, which also
      reads the model: two similar voices may be one speaker to both);
      ``segmentation_gap``, the widest gap between the segmentation
      network's per-speaker activity (rounded to f16, as the program
      hands it on) and the reference's.
    """
    traffic = cell["traffic"]
    lim = cell["limits"]
    exp = traffic["expect"]
    checks = [{"name": "failed_requests", "value": failed, "limit": 0}]
    for key in ("windows", "rows", "decode_steps"):
        bad = [w[key] for w in works if w[key] != exp[key]]
        checks.append({"name": f"{key}_off_layout", "value": len(bad), "limit": 0,
                       "expect": exp[key], "seen": sorted({w[key] for w in works})})
    lo, hi = exp["kept_s"]
    bad = [w["kept_s"] for w in works if not lo <= w["kept_s"] <= hi]
    checks.append({"name": "kept_s_off_layout", "value": len(bad), "limit": 0,
                   "expect": [lo, hi], "seen": sorted({round(w["kept_s"], 3) for w in works})})
    checks.append({"name": "requests_unchecked", "value": int(program is None), "limit": 0})
    if program is None:
        return checks
    toks, fin = program["tokens"], program["finished"]
    lp = (max(abs(a - b) / (len(t) + f)
              for a, b, t, f in zip(program["sums"], want["sums"], toks, fin))
          if toks else float("inf"))
    checks.append({"name": "logprob_gap", "value": lp, "limit": lim["logprob_gap"],
                   "windows": len(toks), "tokens": sum(len(t) for t in toks),
                   "request": kept[0]})
    if traffic["decode"]["word_timestamps"]:
        al = alignment(program, want, cell["config"]["special_tokens"]["eot"])
        checks.append({"name": "align_cost_gap", "value": al["cost_gap"],
                       "limit": lim["align_cost_gap"], "widest": al["cost_gap_widest"],
                       "windows": al["windows"], "word_gap_s": al["word_gap_s"]})
        checks.append({"name": "words_off_path", "value": al["off_path"], "limit": 0})
    kv = ref_layout.keep_vs_speech(program["keep"], truth)
    checks.append({"name": "speech_missed", "value": kv["speech_missed"],
                   "limit": lim["speech_missed"], "silence_kept_s": kv["silence_kept_s"]})
    if not traffic["stages"]["diarization"]:
        return checks
    se = ref_layout.speaker_error(program["turns"], program["keep"], truth)
    checks.append({"name": "turns_gap",
                   "value": ref_layout.turns_gap(program["turns"], want["turns"],
                                                 program["kept_ms"]),
                   "limit": lim["turns_gap"], "turns": len(program["turns"]),
                   "reference_turns": len(want["turns"]), "speaker_error": se["speaker_error"],
                   "speakers": se["speakers_found"]})
    got, ref_act = program["activity"], want["activity"]
    seg = (float((got[: ref_act.shape[0]].float() - ref_act).abs().max())
           if got is not None and ref_act is not None and got.shape[0] >= ref_act.shape[0]
           else float("inf"))
    checks.append({"name": "segmentation_gap", "value": seg, "limit": lim["segmentation_gap"],
                   "windows": None if ref_act is None else int(ref_act.shape[0])})
    return checks

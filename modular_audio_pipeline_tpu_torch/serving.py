"""Device-resident serving pipeline: one upload, statistics-only downloads.

Counterpart of ``modular_audio_pipeline_tpu/serving.py``
(``ServingPipeline.process`` and ``run_file``) over the port's Whisper
stack. The waveform stays on the device end to end:

0. with ``vocal_separation.enabled``: the energy-CV music test on the host
   waveform (``auto_detect``), then the vocal stem, by the
   ``separation-<model>`` bundle's MaskUNet on the device over 5-minute
   chunks of the uploaded audio, or by REPET on the host before the upload
   when no bundle loads;
1. one upload (int16 PCM stays int16 and is converted on the device); per
   section of at most 600 s, denoise (noise-profile search, stationary
   spectral gate) and the decision statistics: per-1 ms block energies,
   32 ms sub-band energies and levels, the ConvVAD's log band features,
   the section peak and K-weighted 100 ms loudness sub-blocks. The host
   combines peaks and sub-blocks into the whole-file peak + gated-LUFS
   gain (:func:`_whole_file_gain`) and rescales the statistics by it;
2. the trained ConvVAD (or a converted Silero VAD, its LSTM state carried
   across 600 s sections) scores each 32 ms window on the device; the host
   intersects silence-kept intervals with its speech and builds the
   :class:`~.protocols.TimestampMapping` table;
3. a block index map goes up, the device gathers the kept audio (16-sample
   blocks, gain applied) into 30 s windows, runs log-mel, the encoder and
   the beam decode (the flash and ancestry kernels), and, for
   diarization, the segmentation and embedding networks over the flat
   kept timeline (the flash kernel again);
4. only statistics, probabilities, tokens, activities and embeddings come
   back.

As in the JAX package, cuts snap to 16-sample blocks, the 20 ms crossfades
at cut points of the stage-by-stage path are skipped, and the serving path
has no temperature ladder. Runs on CUDA unless ``device="cpu"``.

Under a mesh (``mesh=``, a ``DeviceMesh``, or ``tpu.mesh_shape``; one
process per card, ``parallel/mesh.py``) the Whisper parameters are sharded
over the ``model`` axis and each decode batch over the ``data`` axis: the
batch is padded to the axis size, each rank decodes its rows, the padded
rows are discarded, and the per-window results are gathered over the data
group. The DSP statistics, VAD, gather and diarization run replicated on
every rank, as in the JAX package, so ``process`` and ``run_file`` return
the same result on every rank; only rank 0 writes ``run_file``'s JSON.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .protocols import TimestampMapping

logger = logging.getLogger(__name__)

__all__ = ["ServingPipeline"]

_BLOCK = 16  # samples per gather block (1 ms @ 16 kHz)
_VAD_FRAME_MS = 32  # 512 samples @ 16 kHz: the VAD window
_DSP_SECTION_S = 600  # the longest stretch one DSP pass covers
_NO_DEVICE_SEPARATION = object()  # the bundle was probed: none usable


def _dsp_stats(x_ext: torch.Tensor, noise_start: int, sr: int, denoise: bool,
               prop_decrease: float, conv_feats: bool):
    """Denoise + decision statistics of one section, before any gain.

    ``x_ext`` = [1 s of left context | section]; the statistics cover the
    section only. The context seeds the K-weighting so per-section
    loudness sub-blocks equal whole-file filtering to float precision; the
    first section's context is zeros, the whole file's zero state.
    Returns (denoised section, peak, K-weighted 100 ms sub-block mean
    squares, per-ms block sums of squares, 32 ms band energies, frame dB,
    ConvVAD features or an empty [0, 16])."""
    from .models.vad_net import ConvVAD
    from .ops.loudness import k_weight
    from .ops.spectral_gate import spectral_gate_stationary
    from .ops.vad_ops import band_energies

    if x_ext.dtype == torch.int16:
        x_ext = x_ext.float() * (1.0 / 32768.0)
    ctx, x = x_ext[:sr], x_ext[sr:]
    if denoise:
        # lax.dynamic_slice's clamping of the start
        start = min(max(int(noise_start), 0), max(0, x.shape[0] - 2 * sr))
        x = spectral_gate_stationary(x, x[start : start + 2 * sr], sr,
                                     prop_decrease=prop_decrease)
    peak = x.abs().max()
    y = k_weight(torch.cat([ctx, x]), sr)[sr:]
    step = sr // 10
    n_sub = y.shape[0] // step
    ksubs = torch.mean(torch.square(y[: n_sub * step].reshape(n_sub, step)), dim=-1)
    blocks = x.reshape(-1, _BLOCK)
    block_sq = torch.sum(blocks * blocks, dim=-1)
    bands, frame_db = band_energies(x, sr, _VAD_FRAME_MS)
    vfeats = ConvVAD.features(x) if conv_feats else x.new_zeros((0, ConvVAD.N_MELS))
    return x, peak, ksubs, block_sq, bands, frame_db, vfeats


def _blocks_from_subblocks(subs: np.ndarray) -> np.ndarray:
    """400 ms gating-block mean squares from 100 ms sub-block means: each
    BS.1770 block (400 ms, 75 % overlap) is the mean of 4 consecutive
    sub-blocks, so per-section sub-blocks rebuild the whole-file blocks."""
    subs = np.asarray(subs, dtype=np.float64)
    if len(subs) < 4:
        return np.zeros(0, dtype=np.float64)
    c = np.concatenate([[0.0], np.cumsum(subs)])
    return (c[4:] - c[:-4]) / 4.0


def _conv_vad_probs(model, feats: torch.Tensor, gain: float) -> torch.Tensor:
    """The ConvVAD over pre-gain features rescaled for ``gain``: a gain g
    scales band energies by g^2, so invert the log, rescale, re-log
    (the eps floor of digital silence included)."""
    eps = 1e-10
    g = torch.tensor(gain, dtype=torch.float32, device=feats.device)
    e = torch.clamp(torch.pow(10.0, feats) - eps, min=0.0)
    return model(torch.log10(g * g * e + eps))


def _silero_section(model, x: torch.Tensor, gain: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor, tail: torch.Tensor):
    """The converted Silero VAD over one device section, gain applied:
    (probabilities, h, c, the last 64 samples). The LSTM state and the
    64-sample chunk context thread across sections, so a file run in 600 s
    sections equals the whole-file recurrence."""
    chunk, ctx_n = model.CHUNK, model.CONTEXT
    x = x * gain
    n = (x.shape[0] // chunk) * chunk
    frames = x[:n].reshape(-1, chunk)
    prev = torch.cat([tail[None], frames[:-1, -ctx_n:]], dim=0)
    probs, h, c = model.run_carry(torch.cat([prev, frames], dim=1), h, c)  # [N, 576] in
    return probs, h, c, frames[-1, -ctx_n:]


def _whole_file_gain(
    peaks: List[float],
    kblocks: np.ndarray,
    target_lufs: float = -16.0,
    headroom_db: float = 0.1,
) -> Tuple[float, float]:
    """(total_gain, integrated_lufs) from per-section peaks and gating
    blocks: peak normalisation, then BS.1770 gated loudness to the target
    with the unity-peak limiter and the < -70 LUFS skip (host, copied)."""
    peak = float(max(peaks)) if peaks else 0.0
    if peak <= 0.0:
        return 1.0, float("-inf")
    g1 = 10.0 ** (-headroom_db / 20.0) / peak

    z = np.asarray(kblocks, dtype=np.float64) * (g1 * g1)
    offset, abs_gate, rel_gate_lu = -0.691, -70.0, -10.0
    lufs = float("-inf")
    if z.size:
        block_lufs = offset + 10.0 * np.log10(np.maximum(z, 1e-30))
        abs_mask = block_lufs > abs_gate
        if abs_mask.any():
            z_abs = z[abs_mask].mean()
            rel_gate = offset + 10.0 * np.log10(max(z_abs, 1e-30)) + rel_gate_lu
            both = abs_mask & (block_lufs > rel_gate)
            if both.any():
                lufs = offset + 10.0 * np.log10(max(z[both].mean(), 1e-30))

    if not np.isfinite(lufs) or lufs < -70.0:
        return g1, lufs  # loudness normalisation skipped
    g2 = 10.0 ** ((target_lufs - lufs) / 20.0)
    post_peak = peak * g1 * g2
    if post_peak > 1.0:  # unity-peak limiter
        g2 /= post_peak
    return g1 * g2, lufs


def _nonsilent_from_block_sums(
    block_sq: np.ndarray,
    n_valid_ms: int,
    min_silence_len: int = 250,
    silence_offset_db: float = 40.0,
) -> List[Tuple[int, int]]:
    """pydub detect_nonsilent over per-ms block energy sums."""
    from .ops.silence import detect_nonsilent_from_block_sums

    return detect_nonsilent_from_block_sums(
        block_sq, n_valid_ms, min_silence_len=min_silence_len,
        silence_offset_db=silence_offset_db, spms=_BLOCK)


def _speech_probs_from_bands(bands: np.ndarray, frame_db: np.ndarray) -> np.ndarray:
    """Energy-VAD probability calibration (the no-bundle fallback)."""
    k = max(1, len(bands) // 10)
    floor = np.sort(bands, axis=0)[:k].mean(axis=0) + 1e-12
    score = np.log2(1.0 + bands / floor).sum(axis=-1)
    prob = 1.0 / (1.0 + np.exp(-(score - 7.0) / 2.0))
    return np.where(frame_db < -60.0, 0.0, prob).astype(np.float32)


class ServingPipeline:
    """Throughput-oriented transcription + diarization on device tensors.

    ``config`` is this package's ``PipelineConfig`` or the JAX package's;
    ``backend`` a :class:`~.transcriber.TorchWhisperBackend` on ``device``
    (built from the config when None); ``device=None`` means CUDA; ``mesh``
    a ``DeviceMesh`` (built from ``tpu.mesh_shape`` when None and an axis
    exceeds 1).
    """

    def __init__(self, config=None, backend=None, diarize: bool = True, device=None,
                 mesh=None):
        from .config import PipelineConfig
        from .parallel.mesh import check_mesh
        from .transcriber import TorchWhisperBackend, _mesh_from_config
        from .utils import resolve_device

        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        # windows shard on the mesh's 'data' axis, Whisper's parameters on
        # 'model'; the DSP statistics, gather and diarization stay replicated
        if mesh is not None:
            check_mesh(mesh)
        self.mesh = mesh if mesh is not None else _mesh_from_config(self.config, self.device)
        if backend is not None:
            if backend.device != self.device:
                raise ValueError(f"backend on {backend.device}, pipeline on {self.device}")
            self.backend = backend
        else:
            t = self.config.transcription
            self.backend = TorchWhisperBackend(
                model_name=t.model,
                language=t.language,
                beam_size=t.beam_size,
                prompt=t.prompt or "",
                compute_dtype={"float16": "bfloat16"}.get(t.compute_type, t.compute_type),
                weights_path=t.weights_path,
                batch_size=t.batch_size,
                max_decode_tokens=t.max_decode_tokens,
                word_timestamps=t.word_timestamps,
                no_speech_threshold=t.no_speech_threshold,
                logprob_threshold=t.logprob_threshold,
                compression_ratio_threshold=t.compression_ratio_threshold,
                patience=t.patience,
                kv_cache_dtype=getattr(t, "kv_cache_dtype", "int8"),
                device=str(self.device),
                mesh=self.mesh,
            )
        self.diarize_enabled = diarize and self.config.diarization.enabled
        self.word_timestamps = self.config.transcription.word_timestamps
        self._separation_fn = None  # host separation (REPET), once resolved
        self._separation_net = None  # the device MaskUNet, once resolved
        self._vad_model = None  # the ConvVAD or Silero VAD, once resolved
        self._vad_threshold: Optional[float] = None
        self._vad_resolved = False
        self._diarizer = None
        # host seconds of each stage of the last process() call; work a
        # stage leaves queued on the device counts in the next stage
        self.last_timings: Dict[str, float] = {}

    def _resolve_vad(self) -> None:
        """Load the ``vad-silero`` bundle (the ConvVAD or a converted Silero
        VAD); without a loadable bundle the energy-probability VAD runs
        instead, as in the JAX package."""
        if self._vad_resolved:
            return
        self._vad_resolved = True
        cfg = self.config
        self._vad_threshold = cfg.vad.threshold
        if not (cfg.vad.enabled and cfg.vad.provider == "silero"):
            return
        from .vad import load_vad_model

        try:
            self._vad_model, self._vad_threshold = load_vad_model(
                cfg.vad.threshold, device=self.device)
        except Exception as exc:
            logger.warning("VAD bundle load failed (%s); using energy-probability VAD", exc)
            self._vad_model = None

    # -- stages -------------------------------------------------------------

    def process(self, audio: np.ndarray, sr: int) -> Dict[str, Any]:
        from .models.vad_net import ConvVAD, SileroVAD
        from .models.whisper.decode import (
            DecodeOptions,
            _decode_pending,
            detect_language,
            encode_audio_kv,
            finalize_decode,
        )
        from .ops.bucketing import pad_to_bucket
        from .ops.mel import log_mel
        from .ops.noise_detect import longest_noise_run
        from .parallel.mesh import axis_size
        from .transcriber import _BATCH_BUCKETS

        cfg = self.config
        dev = self.device
        timings: Dict[str, float] = {}
        self.last_timings = timings
        t_stage = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t_stage
            now = time.perf_counter()
            timings[name] = timings.get(name, 0.0) + now - t_stage
            t_stage = now

        self.backend.load()
        duration = len(audio) / sr
        audio = np.asarray(audio)
        target_sr = cfg.audio.sample_rate
        if sr != target_sr:
            # the device work assumes 16 kHz (16-sample blocks, mel, 30 s
            # windows): resample on the host first
            from .audio_io import resample_poly

            if audio.dtype == np.int16:
                audio = audio.astype(np.float32) * (1.0 / 32768.0)
            audio = resample_poly(audio, sr, target_sr)
            sr = target_sr

        lap("dsp")
        separated = separate_on_device = False
        if cfg.vocal_separation.enabled:
            separated, separate_on_device, audio = self._separate_host(audio, sr)
            lap("separation")

        if audio.dtype != np.int16:  # int16 stays raw: half the upload bytes
            audio = audio.astype(np.float32, copy=False)
        padded, n_valid = pad_to_bucket(audio, sr)
        dev_audio = torch.from_numpy(np.ascontiguousarray(padded)).to(dev)
        dev_f32 = (dev_audio if dev_audio.dtype == torch.float32
                   else dev_audio.float() * (1.0 / 32768.0))
        if separate_on_device:
            dev_f32 = dev_audio = self._separate_device(dev_f32, n_valid, sr)
            lap("separation")

        # noise-profile position: device features, host percentile decision
        noise_start = 0
        denoise = cfg.noise_reduction.enabled
        if denoise and cfg.noise_reduction.auto_detect_noise:
            run = longest_noise_run(dev_f32, n_valid, sr)
            if run is not None:
                noise_start = min(run[0], max(0, n_valid - 2 * sr))
        del dev_f32

        self._resolve_vad()
        conv_feats = isinstance(self._vad_model, ConvVAD)
        prop = cfg.noise_reduction.prop_decrease
        # sections align to the 512-sample VAD window and the 1600-sample
        # loudness sub-block (lcm 12800), so per-section features and
        # sub-blocks concatenate to the whole-file framing
        section = max(12800, (_DSP_SECTION_S * sr // 12800) * 12800)
        guarded = torch.cat([dev_audio.new_zeros((sr,)), dev_audio])
        outs = []
        for s0 in range(0, len(padded), section):
            ns = noise_start - s0
            if len(padded) > section and not (0 <= ns < section - 2 * sr):
                ns = 0  # the profile lies in another section: this one's start
            outs.append(_dsp_stats(guarded[s0 : s0 + sr + section], ns, sr, denoise, prop,
                                   conv_feats))
        del guarded, dev_audio
        procs, pks, kbs, sqs, bds, fds, vfs = zip(*outs)
        del outs
        dev_proc = torch.cat(procs) if len(procs) > 1 else procs[0]
        block_sq_d = torch.cat(sqs)
        bands_d = torch.cat(bds)
        frame_db_d = torch.cat(fds)
        vfeats_d = torch.cat(vfs)
        peaks = [float(p) for p in torch.stack(pks).cpu()]
        ksubs = torch.cat(kbs).cpu().numpy()
        del procs

        gain, lufs = _whole_file_gain(peaks, _blocks_from_subblocks(ksubs))
        if np.isfinite(lufs):
            logger.debug("Whole-file loudness %.2f LUFS, gain %.4f", lufs, gain)
        n_valid_ms = n_valid // _BLOCK
        # statistics were computed before the gain: rescale on the host
        g2db = 20.0 * np.log10(max(gain, 1e-12))
        block_sq = block_sq_d.cpu().numpy() * gain * gain
        # VAD statistics of valid frames only: the energy VAD's noise floor
        # must not see the bucket's zero padding
        n_valid_frames = n_valid // (sr * _VAD_FRAME_MS // 1000)
        lap("dsp")

        # --- VAD probabilities: trained DNN on device, energy fallback ------
        dnn_probs: Optional[np.ndarray] = None
        bands = frame_db = webrtc_keep = None
        if cfg.vad.enabled and isinstance(self._vad_model, ConvVAD):
            dnn_probs = _conv_vad_probs(self._vad_model, vfeats_d, gain).cpu().numpy()
            dnn_probs = dnn_probs[:n_valid_frames]
        elif cfg.vad.enabled and isinstance(self._vad_model, SileroVAD):
            h = c = torch.zeros(SileroVAD.HID, device=dev)
            tail = torch.zeros(SileroVAD.CONTEXT, device=dev)
            g_dev = torch.tensor(gain, dtype=torch.float32, device=dev)
            parts = []
            for s0 in range(0, len(padded), section):
                p_, h, c, tail = _silero_section(self._vad_model, dev_proc[s0 : s0 + section],
                                                 g_dev, h, c, tail)
                parts.append(p_)
            dnn_probs = torch.cat(parts).cpu().numpy()[:n_valid_frames]
        elif cfg.vad.enabled and cfg.vad.provider == "webrtc":
            webrtc_keep = self._webrtc_keep(dev_proc, n_valid, sr, gain, n_valid_ms)
        elif cfg.vad.enabled:
            bands = bands_d.cpu().numpy()[:n_valid_frames] * gain * gain
            frame_db = frame_db_d.cpu().numpy()[:n_valid_frames] + g2db

        # --- host decisions: silence intervals ∩ VAD speech -----------------
        keep_ms, mappings = self._keep_intervals(
            block_sq, bands, frame_db, n_valid_ms, sr, dnn_probs=dnn_probs,
            vad_keep=webrtc_keep,
        )
        lap("vad")
        if not keep_ms:
            # the full path's schema, so callers never switch on it
            return {
                "text": "", "segments": [], "language": self.backend.language,
                "duration": duration, "kept_duration": 0.0,
                "timestamp_mappings": [], "diarization": [],
                "vocal_separation": separated,
                "decode_stats": {"n_windows": 0, "tokens_decoded": 0,
                                 "mean_tokens_per_window": 0.0},
            }

        # --- device: gather kept blocks into 30 s windows -------------------
        window_samples = int(30.0 * sr)
        win_blocks = window_samples // _BLOCK
        block_ids = np.concatenate([np.arange(s, e, dtype=np.int64) for s, e in keep_ms])
        kept_ms_total = len(block_ids)
        n_win = max(1, int(np.ceil(kept_ms_total / win_blocks)))
        # window-count bucket: the padded count shapes the gather, the
        # decode batches and the diarization timeline
        pad_win = next((c for c in _BATCH_BUCKETS if c >= n_win), ((n_win + 31) // 32) * 32)
        # padding ids point into the zeros beyond n_valid
        pad_block = min(len(padded) // _BLOCK - 1, n_valid_ms)
        ids_padded = np.full(pad_win * win_blocks, pad_block, dtype=np.int64)
        ids_padded[:kept_ms_total] = block_ids
        g = torch.tensor(gain, dtype=torch.float32, device=dev)
        ids = torch.from_numpy(ids_padded).to(dev)
        dev_windows = (dev_proc.reshape(-1, _BLOCK)[ids] * g).reshape(-1, window_samples)
        del dev_proc, ids
        kept_duration = kept_ms_total * _BLOCK / sr
        lap("gather")

        # --- transcription --------------------------------------------------
        backend = self.backend
        language = backend.language
        if language in (None, "", "auto"):
            first_mel = log_mel(dev_windows[:1], n_mels=backend.dims.n_mels)
            language, _ = detect_language(backend.params, backend.dims, backend.tokenizer,
                                          first_mel)
            logger.info("Detected language: %s", language)

        t = cfg.transcription
        opts = DecodeOptions(
            language=language,
            task=t.task,
            beam_size=t.beam_size,
            temperature=t.temperature,
            max_tokens=t.max_decode_tokens,
            timestamps=True,
            prompt_tokens=backend._prompt_tokens(),
            patience=t.patience,
            kv_int8=getattr(t, "kv_cache_dtype", "int8") == "int8",
        )
        bs = backend.batch_size
        n_data = axis_size(backend.mesh, "data")
        pending = []
        for start in range(0, n_win, bs):
            end = min(start + bs, pad_win)
            rows = dev_windows[start:end]
            short = (-rows.shape[0]) % n_data
            if short:  # DP: pad to the data axis; the padded rows are discarded
                rows = torch.cat([rows, rows.new_zeros((short, rows.shape[1]))])
            rows, lo = backend._local_rows(rows)
            mel = log_mel(rows, n_mels=backend.dims.n_mels)
            audio_kv = None
            if self.word_timestamps:
                audio_kv = encode_audio_kv(backend.params, backend.dims, mel)
            pending.append((start, end - start, _decode_pending(
                backend.params, backend.dims, backend.tokenizer, mel, opts,
                audio_kv=audio_kv), audio_kv, lo))

        segments: List[Dict[str, Any]] = []
        n_windows_decoded = 0
        tokens_decoded = 0
        eot = backend.tokenizer.eot
        for start, b, p, audio_kv, lo in pending:
            result = backend._gather_rows(finalize_decode(p))
            align_jobs: List[tuple] = []
            for i in range(min(b, n_win - start)):
                toks = np.asarray(result.tokens[i])
                eot_pos = np.nonzero(toks == eot)[0]
                tokens_decoded += int(eot_pos[0]) + 1 if eot_pos.size else len(toks)
                n_windows_decoded += 1
                if backend._should_skip_window(float(result.no_speech_probs[i]),
                                               float(result.avg_logprobs[i])):
                    continue  # whisper's no-speech gate
                offset = (start + i) * 30.0
                win_dur = min(30.0, kept_duration - offset)
                segs = backend._parse_window(result.tokens[i], float(result.avg_logprobs[i]),
                                             offset, win_dur)
                if self.word_timestamps and segs:
                    align_jobs.append((segs, result.tokens[i], i, offset))
                segments.extend(segs)
            if align_jobs:
                backend._attach_words_batch(align_jobs, audio_kv, opts, lo)
        del pending
        lap("whisper")

        # --- diarization over the flat kept timeline ---------------------------
        diar_turns = []
        if self.diarize_enabled and kept_ms_total > 0:
            diar_turns = self._diarize_windows(
                dev_windows, pad_win, kept_duration, sr,
                cfg.diarization.min_speakers, cfg.diarization.max_speakers)
        lap("diarization")

        return {
            "text": " ".join(s["text"] for s in segments),
            "segments": segments,
            "language": language,
            "duration": duration,
            "kept_duration": kept_duration,
            "timestamp_mappings": mappings,
            "diarization": diar_turns,
            "vocal_separation": separated,
            "decode_stats": {
                "n_windows": n_windows_decoded,
                "tokens_decoded": tokens_decoded,
                "mean_tokens_per_window": (
                    round(tokens_decoded / n_windows_decoded, 1) if n_windows_decoded else 0.0
                ),
            },
        }

    # -- helpers ----------------------------------------------------------------

    def _separate_host(self, audio: np.ndarray, sr: int) -> Tuple[bool, bool, np.ndarray]:
        """(separated, separate on the device, audio): the music test when
        ``auto_detect`` is on; then the device MaskUNet when the bundle
        loads (the audio is returned as it came, and separated after the
        upload), else the host backend over ``chunk_minutes`` chunks (the
        vocal stem is returned)."""
        from .ops.music import analyze_audio_content
        from .separator import get_device_separation, get_separation_backend

        vs = self.config.vocal_separation
        audio_f = (audio.astype(np.float32) * (1.0 / 32768.0) if audio.dtype == np.int16
                   else audio)
        if vs.auto_detect:
            analysis = analyze_audio_content(audio_f, sr, self.device)
            logger.info("Music analysis: %s", analysis)
            if not (analysis.get("has_music", False) and analysis.get("confidence", 0.0) > 0.5):
                return False, False, audio
        if self._separation_net is None:
            self._separation_net = (get_device_separation(vs.model, self.device)
                                    or _NO_DEVICE_SEPARATION)
        if self._separation_net is not _NO_DEVICE_SEPARATION:
            return True, True, audio
        if self._separation_fn is None:
            self._separation_fn = get_separation_backend(vs.model, self.device)
        chunk = max(int(vs.chunk_minutes * 60 * sr), 1)
        vocals = [self._separation_fn(audio_f[s : s + chunk], sr)[0]
                  for s in range(0, len(audio_f), chunk)]
        return True, False, np.concatenate(vocals).astype(np.float32)

    def _separate_device(self, dev_f32: torch.Tensor, n_valid: int, sr: int) -> torch.Tensor:
        """The MaskUNet's vocal stem of the padded device audio, over the
        host path's ``chunk_minutes`` grid (a short file is one chunk of
        its bucket; the last chunk is zero-padded), with the samples past
        ``n_valid`` set back to zero: resynthesis smears energy into the
        padding, and the gather's filler blocks must stay silent."""
        n = dev_f32.shape[0]
        chunk = max(min(int(self.config.vocal_separation.chunk_minutes * 60 * sr), n), 1)
        pieces = []
        for s0 in range(0, n, chunk):
            seg = dev_f32[s0 : s0 + chunk]
            if seg.shape[0] < chunk:
                seg = torch.nn.functional.pad(seg, (0, chunk - seg.shape[0]))
            pieces.append(self._separation_net.separate_device(seg))
        out = torch.cat(pieces)[:n]
        out[n_valid:] = 0.0
        return out

    def run_file(
        self,
        input_wav: str,
        results_dir: Optional[str] = None,
        audio: Optional[np.ndarray] = None,
        sr: Optional[int] = None,
    ):
        """File in, JSON out, with the JAX package's output schema.

        Applies the stage-by-stage pipeline's post-processing: speaker
        alignment, timestamp back-mapping, redundancy removal, segment
        merging. ``audio``/``sr`` skip the file read. Returns a
        :class:`~.pipeline.PipelineResult`; a failure comes back as
        ``success=False``."""
        import json
        import os
        from pathlib import Path

        from .audio_io import read_wav, read_wav_raw_int16
        from .parallel.mesh import world_rank
        from .pipeline import AudioPipeline, PipelineResult
        from .protocols import DiarizationSegment
        from .redundancy import NoOpRedundancyRemover, RedundancyRemover
        from .segment_merger import SegmentMerger

        cfg = self.config
        t0 = time.perf_counter()
        try:
            if audio is None:
                audio, sr = read_wav_raw_int16(input_wav)
                if audio is None:  # not mono 16-bit PCM
                    audio, sr = read_wav(input_wav)
            result = self.process(audio, sr)

            diar = [DiarizationSegment(d["speaker"], d["start"], d["end"])
                    for d in result.get("diarization", [])]
            aligned = AudioPipeline._align_transcription_with_speakers(result["segments"], diar)
            mappings = result.get("timestamp_mappings", [])
            if cfg.preserve_timestamps and mappings:
                for seg in aligned:
                    seg["original_start"] = AudioPipeline._map_timestamp_to_original(
                        seg["start"], mappings)
                    seg["original_end"] = AudioPipeline._map_timestamp_to_original(
                        seg["end"], mappings)

            remover = (RedundancyRemover.from_config(cfg) if cfg.redundancy.enabled
                       else NoOpRedundancyRemover())
            final_segments = remover.remove(aligned)
            if cfg.segment_merging.enabled:
                final_segments = SegmentMerger(
                    max_gap_s=cfg.segment_merging.max_gap_s).merge(final_segments)

            output_data = {
                "metadata": {
                    "source_file": str(input_wav),
                    "config": {
                        "model": cfg.transcription.model,
                        "language": cfg.transcription.language,
                        "vad_provider": cfg.vad.provider,
                        "transcription_backend": cfg.transcription.backend,
                    },
                },
                "segments": final_segments,
            }
            out_path = None
            if results_dir:
                os.makedirs(results_dir, exist_ok=True)
                out_path = os.path.join(results_dir, f"{Path(input_wav).stem}_transcription.json")
                if world_rank() == 0:  # one writer under a mesh: every rank has the result
                    with open(out_path, "w", encoding="utf-8") as f:
                        json.dump(output_data, f, ensure_ascii=False, indent=2)

            wall = time.perf_counter() - t0
            return PipelineResult(
                success=True,
                input_file=str(input_wav),
                output_file=out_path,
                segments=final_segments,
                metadata={
                    "model": cfg.transcription.model,
                    "backend": cfg.transcription.backend,
                    "vad": cfg.vad.provider,
                    "serving": True,
                    "wall_time_s": round(wall, 3),
                    "audio_duration_s": round(result["duration"], 3),
                    "rtf": round(result["duration"] / wall, 2) if wall > 0 else None,
                },
            )
        except Exception as exc:
            logger.exception("Serving pipeline failed: %s", exc)
            return PipelineResult(success=False, input_file=str(input_wav), output_file=None,
                                  segments=[], error=str(exc))

    def _webrtc_keep(self, dev_proc: torch.Tensor, n_valid: int, sr: int, gain: float,
                     n_valid_ms: int) -> np.ndarray:
        """The "webrtc" provider's ms keep mask over the device timeline:
        band statistics on the device at the config's frame grid, rescaled
        for the gain (the SNR score is gain-invariant; the level gate moves
        by 20 log10 g), flags and the hangover machine on the host. Kept
        audio per segment is frames ``[start_f, last_f]`` inclusive."""
        from .ops.vad_ops import band_energies, flags_from_band_stats, hangover_segments

        v = self.config.vad
        frame_ms = v.frame_duration_ms
        frame_len = sr * frame_ms // 1000
        nf = n_valid // frame_len
        keep = np.zeros(n_valid_ms, dtype=bool)
        if nf == 0:
            return keep
        bands_d, db_d = band_energies(dev_proc, sr, frame_ms)
        g2db = 20.0 * np.log10(max(gain, 1e-12))
        bands = bands_d.cpu().numpy()[:nf] * gain * gain
        frame_db = db_d.cpu().numpy()[:nf] + g2db
        flags = flags_from_band_stats(bands, frame_db, v.mode)
        for start_f, last_f, _boundary in hangover_segments(
            flags, frame_ms, v.padding_duration_ms, v.start_threshold, v.stop_threshold,
        ):
            keep[start_f * frame_ms : min(n_valid_ms, (last_f + 1) * frame_ms)] = True
        return keep

    def _keep_intervals(
        self, block_sq, bands, frame_db, n_valid_ms: int, sr: int,
        dnn_probs: Optional[np.ndarray] = None,
        vad_keep: Optional[np.ndarray] = None,
    ) -> Tuple[List[Tuple[int, int]], List[TimestampMapping]]:
        """Silence-kept intervals (with 100 ms margins) intersected with VAD
        speech, in ms blocks, and the mappings of the kept timeline.
        ``dnn_probs``: the ConvVAD's per-32 ms probabilities; ``vad_keep``:
        a ms keep mask (the "webrtc" machine); without either, the energy
        probabilities of ``bands``/``frame_db``."""
        from .models.vad_net import speech_timestamps_from_probs

        cfg = self.config
        merged: List[Tuple[int, int]] = []
        for s, e in _nonsilent_from_block_sums(block_sq, n_valid_ms):
            s = max(0, s - 100)
            e = min(n_valid_ms, e + 100)
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        keep = np.zeros(n_valid_ms, dtype=bool)
        for s, e in merged:
            keep[s:e] = True

        if cfg.vad.enabled and vad_keep is not None:
            keep &= vad_keep[:n_valid_ms]
        elif cfg.vad.enabled:
            probs = dnn_probs if dnn_probs is not None else _speech_probs_from_bands(
                bands, frame_db)
            threshold = (self._vad_threshold if self._vad_threshold is not None
                         else cfg.vad.threshold)
            stamps = speech_timestamps_from_probs(
                probs, sr, threshold=threshold,
                min_speech_duration_ms=cfg.vad.min_speech_duration_ms,
                audio_length_samples=n_valid_ms * _BLOCK,
            )
            speech_keep = np.zeros(n_valid_ms, dtype=bool)
            for st in stamps:  # seconds -> ms
                speech_keep[int(st["start"] * 1000) : min(n_valid_ms, int(st["end"] * 1000))] = True
            keep &= speech_keep

        idx = np.flatnonzero(keep)
        if idx.size == 0:
            return [], []
        breaks = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [idx.size - 1]])
        intervals: List[Tuple[int, int]] = []
        mappings: List[TimestampMapping] = []
        processed_ms = 0
        for s_i, e_i in zip(starts, ends):
            a, b = int(idx[s_i]), int(idx[e_i]) + 1
            dur = b - a
            mappings.append(TimestampMapping(
                processed_start=processed_ms / 1000.0,
                processed_end=(processed_ms + dur) / 1000.0,
                original_start=a / 1000.0,
                original_end=b / 1000.0,
            ))
            intervals.append((a, b))
            processed_ms += dur
        return intervals, mappings

    def _diarize_windows(self, dev_windows: torch.Tensor, pad_win: int, kept_duration: float,
                         sr: int, min_speakers: int, max_speakers: int) -> List[Dict[str, Any]]:
        """The trained diarization stack over the kept timeline: the 30 s
        windows tile it contiguously, so flattening them restores it (to
        the bucketed window count; regions are clipped to the valid
        length)."""
        if self._diarizer is None:
            from .diarizer import SpeakerDiarizer

            self._diarizer = SpeakerDiarizer.from_config(self.config, device=self.device)
        flat = dev_windows[:pad_win].reshape(-1)
        n_valid = min(int(flat.shape[0]), int(round(kept_duration * sr)))
        segs, _ = self._diarizer.diarize_device_timeline(flat, n_valid, sr, min_speakers,
                                                         max_speakers)
        return [{"speaker": s.speaker, "start": s.start, "end": s.end} for s in segs]

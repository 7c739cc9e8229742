"""Speech-to-text with the PyTorch Whisper stack.

Counterpart of ``modular_audio_pipeline_tpu/transcriber.py`` for the
batched window path: ``TorchWhisperBackend`` (the counterpart of
``JaxWhisperBackend``), ``WhisperTranscriber`` and the default
``FasterWhisperTranscriber`` (with its built-in VAD gate) with the same
constructors, ``from_config``, lazy loading and result dict::

    {"text": str, "segments": [{"start","end","text","confidence"}, ...],
     "language": str, "duration": float}

Long audio is cut into 30 s windows, decoded in batches (beam search over
an int8 KV cache by default) and the window-relative timestamp tokens are
re-based onto the file timeline. Windows that fail whisper's quality gates
are decoded again up a ladder of sampling temperatures; with
``word_timestamps`` each segment carries DTW-aligned ``words``;
``compute_type="int8"`` quantises the decoder's weights
(``ops/quant.py``); ``language="auto"`` detects the language from the
first window. ``chunking="sequential"`` runs whisper's seek loop instead
(:meth:`TorchWhisperBackend.seek_decode_step`, shared with
``streaming.StreamingSession``): one window at a time, conditioned on the
text decoded so far, the seek pointer advanced by the last completed
segment. Inside ``AudioPipeline`` the transcribers read the previous
stage's published buffer (``audio_io.get_buffer``) and cut a device
tensor into windows where it lies.

Runs on CUDA unless the caller passes ``device="cpu"``: ``device=None``
means ``"cuda"`` and raises when no CUDA device is present.

Under a mesh (``mesh=``, or ``tpu.mesh_shape`` through ``from_config``;
``parallel/mesh.py``, one process per card) the parameters are sharded
over the ``model`` axis (``parallel/sharding.py``; a weight-only int8 tree
is replicated) and each batch of windows over the ``data`` axis: the
bucket divides the axis, each rank encodes and decodes its block of rows,
and the per-window host results (tokens, log-probabilities, no-speech
probabilities, word timings) are gathered over the data group, so every
rank assembles the same segments. The temperature ladder decodes its
failing windows on every rank. The seek loop decodes one window at a time
on every rank, tensor parallel where the tree is sharded, as the JAX
package's does.

A weight bundle loaded onto a CUDA device goes up through the verified
upload (``runtime/integrity.put_verified_tree``): the host leaves are cast
and sliced for this rank first, so the verified tensors are the ones the
model uses.
"""

from __future__ import annotations

import logging
import os
import time
import zlib
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .audio_io import get_buffer, read_stage_input, resample_poly
from .config import RetryConfig
from .exceptions import ModelLoadError, TranscriptionError
from .models.whisper.config import MODEL_INFO, WHISPER_DIMS, WhisperDims
from .models.whisper.convert import CONVERT_COMMAND, load_params, params_from_numpy
from .models.whisper.decode import (
    DecodeOptions,
    build_initial_tokens,
    decode_windows,
    detect_language,
    encode_audio_kv,
)
from .models.whisper.model import init_params
from .models.whisper.timestamps import align_words, align_words_batched
from .models.whisper.tokenizer import WhisperTokenizer, load_tokenizer
from .ops.mel import log_mel
from .ops.quant import quantize_decoder
from .parallel.mesh import axis_group, axis_rank, axis_size, build_mesh, check_mesh, shard_batch
from .parallel.sharding import ShardedParams, model_group, shard_params
from .runtime import tracing
from .runtime.integrity import put_verified_tree
from .utils import find_weights_bundle, resolve_device, retry_with_backoff, weights_search_roots

logger = logging.getLogger(__name__)

__all__ = ["WhisperTranscriber", "FasterWhisperTranscriber", "TorchWhisperBackend",
           "default_weights_dir"]

_WINDOW_S = 30.0
_SR = 16000
_BATCH_BUCKETS = (1, 2, 4, 8, 16)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _configure(backend: "TorchWhisperBackend", tc) -> None:
    """The decoding options of a ``transcription`` config section that the
    transcribers' constructors do not take."""
    backend.no_speech_threshold = tc.no_speech_threshold
    backend.logprob_threshold = tc.logprob_threshold
    backend.compression_ratio_threshold = tc.compression_ratio_threshold
    backend.patience = tc.patience
    backend.kv_cache_dtype = getattr(tc, "kv_cache_dtype", "int8")
    backend.condition_on_previous_text = getattr(tc, "condition_on_previous_text", True)


def _mesh_from_config(config, device=None):
    """The mesh a config declares (``tpu.mesh_shape``), None unless an axis
    exceeds 1 (as the JAX package's)."""
    shape = config.tpu.mesh_shape
    if not shape or max(int(v) for v in shape.values()) <= 1:
        return None
    return build_mesh(config.tpu, resolve_device(device))


def _gather_object(obj, group) -> list:
    """Every data rank's ``obj``, in rank order (``[obj]`` alone)."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _retry_rng(temp_idx: int, device: torch.device) -> torch.Generator:
    """The generator of one rung of the temperature ladder: a fresh one per
    call with the rung's seed (the JAX package's ``PRNGKey(1000 +
    temp_idx)``), so a retry never depends on what was sampled before."""
    return torch.Generator(device=device).manual_seed(1000 + temp_idx)


def default_weights_dir(model_name: str) -> str:
    """The ``whisper-<name>`` bundle of the first search root that holds one
    (``utils.weights_search_roots``: ``MAP_TPU_WEIGHTS`` alone, else
    ``~/.cache/map_tpu`` before the shipped bundles); without one, that name
    under the last root, as the JAX package's ``default_weights_dir``."""
    found = find_weights_bundle(f"whisper-{model_name}")
    if found is not None:
        return str(found)
    return str(weights_search_roots()[-1] / f"whisper-{model_name}")


def _random_fallback_allowed() -> bool:
    return os.environ.get("MAP_TPU_ALLOW_RANDOM_WEIGHTS") == "1"


class TorchWhisperBackend:
    """Shared engine: params + tokenizer + batched window decoding."""

    def __init__(
        self,
        model_name: str,
        language: str = "en",
        task: str = "transcribe",
        temperature: float = 0.0,
        beam_size: int = 5,
        prompt: str = "",
        weights_path: Optional[str] = None,
        compute_dtype: str = "bfloat16",
        batch_size: int = 16,
        max_decode_tokens: int = 224,
        timestamps: bool = True,
        word_timestamps: bool = False,
        temperature_fallback: bool = True,
        chunking: str = "batched",
        no_speech_threshold: Optional[float] = 0.6,
        logprob_threshold: Optional[float] = -1.0,
        compression_ratio_threshold: Optional[float] = 2.4,
        patience: Optional[float] = None,
        kv_cache_dtype: str = "int8",
        condition_on_previous_text: bool = True,
        device: Optional[str] = None,
        mesh=None,  # DeviceMesh: windows on its 'data' axis, params on 'model'
    ):
        if model_name not in WHISPER_DIMS:
            raise ModelLoadError(f"Unknown Whisper model: {model_name}")
        if mesh is not None:
            check_mesh(mesh)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model_name = model_name
        self.dims: WhisperDims = WHISPER_DIMS[model_name]
        self.language = language
        self.task = task
        self.temperature = temperature
        self.beam_size = beam_size
        self.prompt = prompt or ""
        self.weights_path = weights_path
        self.compute_dtype = compute_dtype
        self.batch_size = batch_size
        self.max_decode_tokens = max_decode_tokens
        self.timestamps = timestamps
        self.word_timestamps = word_timestamps
        self.temperature_fallback = temperature_fallback
        self.chunking = chunking
        self.no_speech_threshold = no_speech_threshold
        self.logprob_threshold = logprob_threshold
        self.compression_ratio_threshold = compression_ratio_threshold
        self.patience = patience
        self.kv_cache_dtype = kv_cache_dtype
        self.condition_on_previous_text = condition_on_previous_text  # the seek loop's
        self.fallback_temperatures = (0.2, 0.4, 0.6, 0.8, 1.0)
        self.params = None
        self.tokenizer: Optional[WhisperTokenizer] = None
        # windows and decoded tokens of the last transcribe_array call
        # and the seconds its word-alignment passes took
        self.last_stats: Dict[str, Any] = {}

        # lazy loading finds a missing checkpoint only after preprocessing:
        # say so now, as the JAX package's backend does
        resolved = self.weights_path or default_weights_dir(model_name)
        if (not str(resolved).startswith("random") and not Path(resolved, "params.npz").exists()
                and not _random_fallback_allowed()):
            logger.warning("No converted checkpoint at %s — transcription will fail at "
                           "load time unless one is converted first", resolved)

    # -- lifecycle ---------------------------------------------------------

    def load(self) -> None:
        if self.params is not None:
            return
        # "int8" loads bf16, then quantises the decoder below
        dtype = _DTYPES.get(self.compute_dtype, torch.bfloat16)
        path = self.weights_path or default_weights_dir(self.model_name)

        if str(path).startswith("random"):
            seed = int(str(path).partition(":")[2] or 0)
            logger.warning(
                "Initialising %s with RANDOM weights (seed %d) — test/bench mode",
                self.model_name, seed,
            )
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = self._shard(init_params(self.dims, gen, dtype, self.device))
            self.tokenizer = load_tokenizer(None, n_vocab=self.dims.n_vocab)
            self._maybe_quantize()
            # Quality gates are meaningless on random weights: every window
            # would walk the whole retry ladder.
            self.temperature_fallback = False
            return

        if not Path(path, "params.npz").exists():
            if _random_fallback_allowed():
                # the JAX package's fallback keeps the ladder armed and
                # leaves the tree unquantised; so does this one
                logger.warning("No checkpoint at %s; falling back to random weights "
                               "(MAP_TPU_ALLOW_RANDOM_WEIGHTS=1)", path)
                gen = torch.Generator(device=self.device).manual_seed(0)
                self.params = self._shard(init_params(self.dims, gen, dtype, self.device))
                self.tokenizer = load_tokenizer(None, n_vocab=self.dims.n_vocab)
                return
            raise ModelLoadError(
                f"No converted Whisper checkpoint for '{self.model_name}'",
                details=(
                    f"Expected params.npz under {path}. Convert one offline with:\n"
                    f"  {CONVERT_COMMAND} --src <hf-or-openai-ckpt> --dst {path} "
                    f"--model {self.model_name}"
                ),
            )
        # cast and slice on the host, then upload what the model will use
        host = self._shard(params_from_numpy(load_params(path), "cpu", dtype))
        if self.device.type == "cuda":
            dev = put_verified_tree(host, self.device, name="whisper")
            host = ShardedParams(dev, host.model) if model_group(host) else dev
        self.params = host
        self.tokenizer = load_tokenizer(path, n_vocab=self.dims.n_vocab)
        self._maybe_quantize()
        logger.info("Loaded Whisper %s from %s", self.model_name, path)

    def _shard(self, tree):
        """This rank's slices over the mesh's ``model`` axis; the whole
        tree without one. A tree to be quantised (``compute_dtype="int8"``)
        has no tensor-parallel spec and is replicated (data parallelism
        still applies), as the JAX package's fallback does."""
        if axis_size(self.mesh, "model") <= 1:
            return tree
        if self.compute_dtype == "int8":
            logger.warning("compute_type=int8: the weight-only int8 tree has no tensor-parallel "
                           "spec; replicated over model=%d", axis_size(self.mesh, "model"))
            return tree
        return shard_params(tree, self.mesh, "model", dims=self.dims)

    # -- data parallelism ----------------------------------------------------

    def _local_rows(self, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """This rank's contiguous block of a batch whose rows divide the
        data axis, and the index of its first row."""
        if axis_size(self.mesh, "data") <= 1:
            return x, 0
        local, _ = shard_batch(self.mesh, x, "data")
        return local, axis_rank(self.mesh, "data") * local.shape[0]

    def _gather_rows(self, result):
        """A batch's ``DecodeResult`` from every data rank's block, in row
        order (the result itself without a data axis)."""
        group = axis_group(self.mesh, "data")
        if group is None:
            return result
        parts = _gather_object(result, group)
        return type(result)(*(np.concatenate(f) for f in zip(*parts)))

    def _decode_batch(self, mel: torch.Tensor, opts: DecodeOptions):
        """Encode + decode a batch of mel windows, this rank's rows on a
        data axis -> (``DecodeResult`` of every row, the audio K/V of this
        rank's rows when words are asked for, this rank's first row)."""
        local, lo = self._local_rows(mel)
        # with word timestamps the audio K/V is encoded once and serves
        # both the decode and the alignment pass
        audio_kv = (encode_audio_kv(self.params, self.dims, local)
                    if self.word_timestamps else None)
        result = decode_windows(self.params, self.dims, self.tokenizer, local, opts,
                                audio_kv=audio_kv)
        return self._gather_rows(result), audio_kv, lo

    def _maybe_quantize(self) -> None:
        if self.compute_dtype == "int8":
            self.params = quantize_decoder(self.params)
            logger.info("Decoder quantized to weight-only int8")

    def unload(self) -> None:
        self.params = None

    # -- audio -> windows ---------------------------------------------------

    @staticmethod
    def _windows(audio: np.ndarray) -> np.ndarray:
        """Pad to a whole number of 30 s windows -> [n_windows, 480000]."""
        win = int(_WINDOW_S * _SR)
        n = max(1, int(np.ceil(len(audio) / win)))
        padded = np.zeros(n * win, dtype=np.float32)
        padded[: len(audio)] = audio
        return padded.reshape(n, win)

    def _prompt_tokens(self) -> tuple:
        if not self.prompt or self.tokenizer is None:
            return ()
        ids = self.tokenizer.encode(" " + self.prompt.strip())
        # whisper caps the conditioning prompt at half the text context
        return tuple(ids[-(self.dims.n_text_ctx // 2 - 1):])

    @staticmethod
    def _compression_ratio(text: str) -> float:
        """zlib compression ratio — whisper's repetition-loop detector."""
        data = text.encode("utf-8")
        if not data:
            return 0.0
        return len(data) / len(zlib.compress(data))

    def _needs_fallback(self, result, tokens_row, text: str) -> bool:
        """Whisper's quality gates, which send a window up the ladder:
        ``result`` is the window's average log-probability (None: no
        decode yet, so it needs one)."""
        if result is None:
            return True
        cr = self.compression_ratio_threshold
        lp = self.logprob_threshold
        return (
            (cr is not None and self._compression_ratio(text) > cr)
            or (lp is not None and float(result) < lp)
        )

    def _should_skip_window(self, no_speech_prob: float, avg_logprob: float) -> bool:
        """Whisper's no-speech gate: drop the window as silence when
        no_speech_prob is high, unless the decode is confident anyway."""
        if self.no_speech_threshold is None:
            return False
        should_skip = no_speech_prob > self.no_speech_threshold
        if self.logprob_threshold is not None and avg_logprob > self.logprob_threshold:
            should_skip = False
        return should_skip

    # -- decoding ------------------------------------------------------------

    def _decode_options(self, language: str) -> DecodeOptions:
        return DecodeOptions(
            language=language,
            task=self.task,
            beam_size=self.beam_size,
            temperature=self.temperature,
            max_tokens=self.max_decode_tokens,
            timestamps=self.timestamps,
            prompt_tokens=self._prompt_tokens(),
            patience=self.patience,
            kv_int8=self.kv_cache_dtype == "int8",
        )

    def transcribe_buffer(self, buf) -> Dict[str, Any]:
        """Transcribe a published stage buffer (``audio_io.AudioBuffer``):
        a padded tensor on the device is cut into its 30 s windows where it
        lies; a host buffer, another sample rate, a length off the window
        grid or sequential chunking (the seek loop is driven from the host)
        takes the host path."""
        win = int(_WINDOW_S * _SR)
        t = buf.tensor
        if (t is None or buf.sr != _SR or self.chunking == "sequential"
                or int(t.shape[-1]) % win):
            return self.transcribe_array(buf.as_host(), buf.sr)
        return self.transcribe_array(None, _SR, _dev=t, _n_valid=buf.n_valid)

    def transcribe_array(self, audio: Optional[np.ndarray], sr: int, _dev=None, _n_valid=None
                         ) -> Dict[str, Any]:
        """``_dev``/``_n_valid``: a padded device waveform (zeros past
        ``_n_valid``, a whole number of windows long) in place of ``audio``."""
        self.load()
        win = int(_WINDOW_S * _SR)
        if _dev is None:
            if sr != _SR:
                audio = resample_poly(audio, sr, _SR)
            duration = len(audio) / _SR
            windows = self._windows(audio)
            n_win = windows.shape[0]
        else:
            duration = _n_valid / _SR
            n_win = max(1, -(-_n_valid // win))
            windows = _dev[: n_win * win].reshape(n_win, win).float()

        def batch(start: int, b: int, bucket: int) -> torch.Tensor:
            """Windows [start, start + b) zero-padded to ``bucket`` rows."""
            if _dev is None:
                padded = np.zeros((bucket, win), np.float32)
                padded[:b] = windows[start : start + b]
                return torch.from_numpy(padded).to(self.device)
            rows = windows[start : start + b]
            return torch.cat([rows, rows.new_zeros((bucket - b, win))]) if bucket > b else rows

        language = self.language
        if language in (None, "", "auto"):
            first_mel = log_mel(batch(0, 1, 1), n_mels=self.dims.n_mels)
            language, _ = detect_language(self.params, self.dims, self.tokenizer, first_mel)
            logger.info("Detected language: %s", language)
        opts = self._decode_options(language)

        if self.chunking == "sequential":  # transcribe_buffer sends it the host audio
            return self._transcribe_sequential(audio, duration, opts, language)

        segments: List[Dict[str, Any]] = []
        texts: List[str] = []
        stats = {"windows": 0, "decode_tokens": 0, "retried_windows": 0, "align_s": 0.0}
        n_data = axis_size(self.mesh, "data")
        for start in range(0, n_win, self.batch_size):
            b = min(self.batch_size, n_win - start)
            # bucket the batch so a bounded set of shapes runs; on a mesh the
            # bucket divides the data axis
            bucket = next((c for c in _BATCH_BUCKETS if c >= b and c % n_data == 0),
                          -(-b // n_data) * n_data)
            mel = log_mel(batch(start, b, bucket), n_mels=self.dims.n_mels)
            result, audio_kv, lo = self._decode_batch(mel, opts)
            stats["windows"] += b
            stats["decode_tokens"] += int(result.lengths[:b].sum())
            tokens_rows = {i: result.tokens[i] for i in range(b)}
            avg_lp = {i: float(result.avg_logprobs[i]) for i in range(b)}

            # Temperature-fallback ladder (whisper's decode heuristics):
            # windows with a repetition loop or a low average log-probability
            # are decoded again at increasing sampling temperatures.
            if self.temperature_fallback and opts.temperature == 0.0:
                failing = [
                    i for i in range(b)
                    if self._needs_fallback(avg_lp[i], tokens_rows[i], self.tokenizer.decode(
                        [t for t in tokens_rows[i] if t < self.tokenizer.eot]))
                ]
                stats["retried_windows"] += len(failing)
                if failing:
                    for i, (toks, lp) in self._retry_windows(mel, failing, opts).items():
                        tokens_rows[i], avg_lp[i] = toks, lp

            align_jobs: List[tuple] = []
            for i in range(b):
                if self._should_skip_window(float(result.no_speech_probs[i]), avg_lp[i]):
                    continue  # whisper drops silent/music windows entirely
                offset = (start + i) * _WINDOW_S
                win_dur = min(_WINDOW_S, duration - offset)
                segs = self._parse_window(tokens_rows[i], avg_lp[i], offset, win_dur)
                if self.word_timestamps and segs:
                    align_jobs.append((segs, tokens_rows[i], i, offset))
                segments.extend(segs)
                texts.extend(s["text"] for s in segs)
            if align_jobs:
                t0 = time.perf_counter()
                self._attach_words_batch(align_jobs, audio_kv, opts, lo)
                stats["align_s"] += time.perf_counter() - t0
        self.last_stats = stats
        return {
            "text": " ".join(t for t in texts if t),
            "segments": segments,
            "language": language,
            "duration": duration,
        }

    def _transcribe_sequential(self, audio: np.ndarray, duration: float, opts: DecodeOptions,
                               language: str) -> Dict[str, Any]:
        """Whisper's seek loop over the whole file: each 30 s window is
        conditioned on the text decoded before it, and the seek pointer
        advances by the window's last completed segment, so a segment that
        straddles a fixed 30 s boundary is decoded again from its start.
        Windows that fail the no-speech gate are skipped whole. Segments
        carry no words (the JAX package attaches none here either)."""
        win = int(_WINDOW_S * _SR)
        segments: List[Dict[str, Any]] = []
        all_tokens: List[int] = []  # decoded text tokens, for the conditioning
        self.last_stats = {"windows": 0, "decode_tokens": 0, "retried_windows": 0,
                           "align_s": 0.0}
        seek = 0
        while seek < len(audio):
            segs, advance, all_tokens = self.seek_decode_step(
                audio[seek : seek + win], seek, opts, all_tokens)
            segments.extend(segs)
            seek += advance
        return {
            "text": " ".join(s["text"] for s in segments if s["text"]),
            "segments": segments,
            "language": language,
            "duration": duration,
        }

    def seek_decode_step(self, chunk: np.ndarray, seek: int, opts: DecodeOptions,
                         all_tokens: List[int]) -> Tuple[List[Dict[str, Any]], int, List[int]]:
        """Decode ONE seek window (at most 30 s of audio at sample offset
        ``seek``), conditioned on the text tokens consumed so far.

        Returns ``(segments, advance_samples, all_tokens)``, the step that
        the sequential loop and ``streaming.StreamingSession`` share;
        ``advance_samples`` is always > 0. Once there is text to condition
        on, the prompt is left-padded to ``n_text_ctx // 2 - 1`` tokens
        with the space token, so the prefix is 227 tokens long (the previous
        text's start token, 223 prompt tokens and the 3-token SOT block of a
        set language), and a window that decodes its full budget runs past
        position 447 (``decoder_forward`` treats those positions as the JAX
        package does).
        """
        win = int(_WINDOW_S * _SR)
        base_prompt = list(self._prompt_tokens())
        cap = self.dims.n_text_ctx // 2 - 1
        space = self.tokenizer.encode(" ")
        pad_tok = space[0] if space else 220

        win_dur = len(chunk) / _SR
        padded = np.zeros(win, dtype=np.float32)
        padded[: len(chunk)] = chunk
        if self.condition_on_previous_text:
            prompt = (base_prompt + all_tokens)[-cap:]
        else:
            prompt = base_prompt[-cap:]
        # one prompt length after the first window, as the JAX package
        # pads it (one compiled prefill shape there)
        if prompt:
            prompt = [pad_tok] * (cap - len(prompt)) + prompt
        w_opts = replace(opts, prompt_tokens=tuple(prompt))
        mel = log_mel(torch.from_numpy(padded[None]).to(self.device), n_mels=self.dims.n_mels)
        result = decode_windows(self.params, self.dims, self.tokenizer, mel, w_opts)
        avg_lp = float(result.avg_logprobs[0])
        no_speech = float(result.no_speech_probs[0])
        tokens_row = result.tokens[0]
        stats = self.last_stats
        stats["windows"] = stats.get("windows", 0) + 1
        stats["decode_tokens"] = stats.get("decode_tokens", 0) + int(result.lengths[0])

        if self.temperature_fallback and w_opts.temperature == 0.0:
            text = self.tokenizer.decode([t for t in tokens_row if t < self.tokenizer.eot])
            if self._needs_fallback(avg_lp, tokens_row, text):
                stats["retried_windows"] = stats.get("retried_windows", 0) + 1
                retried = self._retry_windows(mel, [0], w_opts)
                if 0 in retried:
                    tokens_row, avg_lp = retried[0]

        if self._should_skip_window(no_speech, avg_lp):
            return [], len(chunk), all_tokens  # a silent window: move on

        segs, advance_s, consumed = self._parse_window_seek(
            tokens_row, avg_lp, seek / _SR, win_dur)
        if advance_s <= 0:  # degenerate grammar output: force progress
            advance_s = win_dur
        return segs, int(round(advance_s * _SR)), all_tokens + consumed

    def _parse_window_seek(self, tokens, avg_logprob: float, offset: float, win_dur: float):
        """openai-whisper's segment slicing for the seek loop.

        Returns ``(segments, advance_seconds, consumed_text_tokens)``: when
        the window ends mid-segment (the last timestamps form a pair), only
        completed segments are emitted and the seek advances to the last
        paired timestamp; a single trailing timestamp means the whole
        window was consumed.
        """
        tok = self.tokenizer
        content: List[int] = []
        for t in tokens:
            t = int(t)
            if t == tok.eot:
                break
            content.append(t)
        if not content:
            return [], win_dur, []

        is_ts = [tok.is_timestamp(t) for t in content]
        single_ts_ending = len(content) >= 2 and not is_ts[-2] and is_ts[-1]
        consecutive = [i + 1 for i in range(len(content) - 1) if is_ts[i] and is_ts[i + 1]]

        def emit(sub: List[int], out: List[Dict[str, Any]]):
            start_ts = tok.timestamp_to_seconds(sub[0])
            end_ts = tok.timestamp_to_seconds(sub[-1])
            if start_ts >= win_dur:
                return
            text = tok.decode([t for t in sub if not tok.is_timestamp(t)]).strip()
            if not text:
                return
            out.append({
                "start": round(offset + start_ts, 3),
                "end": round(offset + min(end_ts, win_dur), 3),
                "text": text,
                "confidence": avg_logprob,
            })

        out: List[Dict[str, Any]] = []
        if consecutive:
            slices = list(consecutive)
            if single_ts_ending:
                slices.append(len(content))
            last = 0
            for cur in slices:
                emit(content[last:cur], out)
                last = cur
            if single_ts_ending:
                advance = win_dur  # the whole window consumed
            else:
                # seek to the end of the last completed segment
                advance = tok.timestamp_to_seconds(content[last - 1])
            consumed = [t for t in content[:last] if not tok.is_timestamp(t)]
            return out, advance, consumed

        # no completed pair: one segment spanning to the last timestamp
        dur = win_dur
        ts_list = [t for t in content if tok.is_timestamp(t)]
        if ts_list and ts_list[-1] != tok.timestamp_begin:
            dur = min(win_dur, tok.timestamp_to_seconds(ts_list[-1]))
        text = tok.decode([t for t in content if not tok.is_timestamp(t)]).strip()
        if text:
            out.append({
                "start": round(offset, 3),
                "end": round(offset + dur, 3),
                "text": text,
                "confidence": avg_logprob,
            })
        consumed = [t for t in content if not tok.is_timestamp(t)]
        return out, win_dur, consumed

    def _retry_windows(self, mel: torch.Tensor, failing: List[int], opts: DecodeOptions
                       ) -> Dict[int, tuple]:
        """Decode the failing windows again up the temperature ladder.

        Returns ``{window_index: (tokens, avg_logprob)}``: the first rung's
        result that passes the quality gates, or the last rung's whatever
        it is (whisper keeps the final result even when imperfect). Each
        rung decodes greedily with sampling, the failing rows padded to a
        batch bucket by repeating the last one, from a generator seeded
        per rung, so the same file retries the same way every time.
        """
        out: Dict[int, tuple] = {}
        remaining = list(failing)
        for temp_idx, temp in enumerate(self.fallback_temperatures):
            if not remaining:
                break
            bucket = next((c for c in _BATCH_BUCKETS if c >= len(remaining)), len(remaining))
            rows = (remaining + [remaining[-1]] * bucket)[:bucket]
            sub_mel = mel[torch.tensor(rows, dtype=torch.int64, device=mel.device)]
            retry_opts = replace(opts, temperature=float(temp), beam_size=1)
            result = decode_windows(self.params, self.dims, self.tokenizer, sub_mel, retry_opts,
                                    rng=_retry_rng(temp_idx, mel.device))
            still: List[int] = []
            for j, win in enumerate(remaining):
                toks = result.tokens[j]
                lp = float(result.avg_logprobs[j])
                text = self.tokenizer.decode([t for t in toks if t < self.tokenizer.eot])
                if (self._needs_fallback(lp, toks, text)
                        and temp != self.fallback_temperatures[-1]):
                    still.append(win)
                else:
                    out[win] = (toks, lp)
            remaining = still
            if remaining:
                logger.debug("temperature fallback: %d windows retry at > %.1f",
                             len(remaining), temp)
        return out

    @tracing.spanned("whisper.words")
    def _attach_words_batch(self, jobs: List[tuple], audio_kv, opts: DecodeOptions,
                            lo: int = 0) -> None:
        """DTW word alignment for a batch of windows in one (or a few)
        passes: ``jobs`` are ``(segs, tokens, window_idx, offset)``; each
        segment gets its ``words`` and word-tight boundaries. ``audio_kv``
        holds the rows from ``lo`` on: on a data axis each rank aligns the
        windows it decoded, at the whole batch's sequence bucket, and the
        words are gathered over the data group."""
        if not jobs:
            return
        xa_k, xa_v = audio_kv
        eot = self.tokenizer.eot
        prefix, _ = build_initial_tokens(self.tokenizer, opts)
        longest = max(len(prefix) + sum(int(t) != eot for t in tokens)
                      for (_, tokens, _, _) in jobs)
        n_rows = xa_k.shape[1]
        mine = [(idx - lo, [int(t) for t in tokens], prefix)
                for (_, tokens, idx, _) in jobs if lo <= idx < lo + n_rows]
        words = {}
        if mine:
            aligned = align_words_batched(self.params, self.dims, self.tokenizer, xa_k, xa_v,
                                          mine, longest=longest)
            words = {idx + lo: w for (idx, _, _), w in zip(mine, aligned)}
        group = axis_group(self.mesh, "data")
        if group is not None:
            words = {k: v for part in _gather_object(words, group) for k, v in part.items()}
        for segs, _, idx, offset in jobs:
            self._apply_words(segs, words[idx], offset)

    def _attach_words(self, segs: List[Dict[str, Any]], tokens, audio_kv, window_idx: int,
                      opts: DecodeOptions, offset: float) -> None:
        """Single-window DTW word alignment (no caller in either package's
        paths; tests hold it equal to the batched pass)."""
        xa_k, xa_v = audio_kv
        prefix, _ = build_initial_tokens(self.tokenizer, opts)
        i = window_idx
        words = align_words(
            self.params, self.dims, self.tokenizer,
            xa_k[:, i : i + 1], xa_v[:, i : i + 1], [int(t) for t in tokens], prefix)
        self._apply_words(segs, words, offset)

    @staticmethod
    def _apply_words(segs: List[Dict[str, Any]], words: List[Dict[str, float]],
                     offset: float) -> None:
        if not words:
            return
        for seg in segs:
            s0 = seg["start"] - offset
            s1 = seg["end"] - offset
            inside = [
                {"word": w["word"],
                 "start": round(w["start"] + offset, 3),
                 "end": round(w["end"] + offset, 3)}
                for w in words
                if s0 - 0.2 <= (w["start"] + w["end"]) / 2 <= s1 + 0.2
            ]
            if inside:
                seg["words"] = inside
                # word-level boundaries are tighter than timestamp tokens
                seg["start"] = min(seg["start"], inside[0]["start"])
                seg["end"] = max(seg["end"], inside[-1]["end"])

    def _parse_window(
        self, tokens: np.ndarray, avg_logprob: float, offset: float, win_dur: float
    ) -> List[Dict[str, Any]]:
        """Timestamp-token grammar -> segment dicts on the file timeline."""
        tok = self.tokenizer
        eot = tok.eot

        if not self.timestamps:
            ids = [int(t) for t in tokens if int(t) != eot and not tok.is_timestamp(int(t))]
            text = tok.decode(ids).strip()
            if not text:
                return []
            return [{"start": round(offset, 3), "end": round(offset + win_dur, 3),
                     "text": text, "confidence": avg_logprob}]

        segs = []
        cur_start: Optional[float] = None
        cur_text: List[int] = []
        for t in tokens:
            t = int(t)
            if t == eot:
                break
            if tok.is_timestamp(t):
                ts = tok.timestamp_to_seconds(t)
                if cur_start is not None and cur_text:
                    segs.append((cur_start, ts, cur_text))
                    cur_text = []
                    cur_start = None
                else:
                    cur_start = ts
            else:
                cur_text.append(t)
        if cur_start is not None and cur_text:
            segs.append((cur_start, min(_WINDOW_S, win_dur), cur_text))

        out = []
        for s, e, ids in segs:
            if s >= win_dur:
                continue
            text = tok.decode(ids).strip()
            if not text:
                continue
            out.append({
                "start": round(offset + s, 3),
                "end": round(offset + min(e, win_dur), 3),
                "text": text,
                "confidence": avg_logprob,
            })
        return out


class WhisperTranscriber:
    """Reference-compatible transcriber on the PyTorch stack.

    Same constructor as the JAX package's ``WhisperTranscriber``, with
    ``device``; ``mesh`` is a ``DeviceMesh`` (``parallel/mesh.build_mesh``).
    """

    MODEL_INFO = MODEL_INFO

    def __init__(
        self,
        model_name: str = "large-v3-turbo",
        language: str = "pt",
        prompt: str = "",
        task: str = "transcribe",
        temperature: float = 0.0,
        beam_size: int = 5,
        lazy_load: bool = True,
        weights_path: Optional[str] = None,
        batch_size: int = 16,
        word_timestamps: bool = True,
        chunking: str = "batched",
        max_decode_tokens: int = 224,
        device: Optional[str] = None,
        mesh=None,
    ) -> None:
        self.model_name = model_name
        self.language = language
        self.prompt = prompt
        self.task = task
        self.temperature = temperature
        self.beam_size = beam_size

        if model_name not in self.MODEL_INFO and model_name in WHISPER_DIMS:
            logger.info("Using non-standard model: %s", model_name)
        elif model_name not in WHISPER_DIMS:
            logger.warning("Unknown model: %s. Proceeding anyway.", model_name)
        else:
            info = self.MODEL_INFO[model_name]
            logger.info("Whisper model: %s (%s params, ~%dGB device memory)",
                        model_name, info["params"], info["vram_gb"])

        self._backend = TorchWhisperBackend(
            model_name=model_name if model_name in WHISPER_DIMS else "tiny",
            language=language,
            task=task,
            temperature=temperature,
            beam_size=beam_size,
            prompt=prompt,
            weights_path=weights_path,
            batch_size=batch_size,
            word_timestamps=word_timestamps,
            chunking=chunking,
            max_decode_tokens=max_decode_tokens,
            device=device,
            mesh=mesh,
        )
        if not lazy_load:
            self.load_model()

    @classmethod
    def from_config(cls, config, device: Optional[str] = None) -> "WhisperTranscriber":
        """Build from a config exposing ``transcription`` and
        ``lazy_load_models`` (this package's or the JAX package's)."""
        tc = config.transcription
        inst = cls(
            model_name=tc.model,
            language=tc.language,
            prompt=tc.prompt or "",
            task=tc.task,
            temperature=tc.temperature,
            beam_size=tc.beam_size,
            lazy_load=True,
            weights_path=tc.weights_path,
            batch_size=tc.batch_size,
            word_timestamps=tc.word_timestamps,
            chunking=tc.chunking,
            max_decode_tokens=tc.max_decode_tokens,
            device=device,
            mesh=_mesh_from_config(config, device),
        )
        _configure(inst._backend, tc)
        inst._backend.compute_dtype = {"float16": "bfloat16"}.get(tc.compute_type, tc.compute_type)
        if not config.lazy_load_models:
            inst.load_model()
        return inst

    def is_loaded(self) -> bool:
        return self._backend.params is not None

    def load_model(self) -> None:
        self._backend.load()

    def unload_model(self) -> None:
        if self.is_loaded():
            self._backend.unload()
            logger.info("Whisper model unloaded")

    @retry_with_backoff(
        config=RetryConfig(max_attempts=2, initial_delay_s=2.0),
        exceptions=(RuntimeError,),
    )
    def transcribe(self, input_wav: str) -> Dict[str, Any]:
        logger.info("Transcribing: %s", input_wav)
        try:
            buf = get_buffer(input_wav)
            if buf is not None and buf.tensor is not None:
                result = self._backend.transcribe_buffer(buf)
            else:
                audio, sr = read_stage_input(input_wav)
                result = self._backend.transcribe_array(audio, sr)
        except RuntimeError:
            raise
        except Exception as exc:
            raise TranscriptionError(
                f"Transcription failed for: {input_wav}", details=str(exc)
            )
        logger.info(
            "Transcription complete: %d segments, %d chars",
            len(result["segments"]), len(result["text"]),
        )
        return result

    def transcribe_with_options(self, input_wav: str, **kwargs) -> Dict[str, Any]:
        """One call with backend options overridden (``language``, ``task``,
        ``temperature``, ``beam_size``, ``initial_prompt``, ...); the
        options are restored afterwards."""
        saved = {}
        backend = self._backend
        for key, val in kwargs.items():
            name = {"initial_prompt": "prompt"}.get(key, key)
            if hasattr(backend, name):
                saved[name] = getattr(backend, name)
                setattr(backend, name, val)
        try:
            buf = get_buffer(input_wav)
            if buf is not None and buf.tensor is not None:
                return backend.transcribe_buffer(buf)
            audio, sr = read_stage_input(input_wav)
            return backend.transcribe_array(audio, sr)
        except Exception as exc:
            raise TranscriptionError("Transcription failed", details=str(exc))
        finally:
            for name, val in saved.items():
                setattr(backend, name, val)


class FasterWhisperTranscriber:
    """The default transcriber (``transcription.backend="faster-whisper"``):
    the same backend behind faster-whisper's facade, with its built-in VAD
    gate. Speech-free stretches are zeroed (the timeline kept) by the
    energy classifier and hangover machine before windowing, on the
    device for a device buffer (:meth:`_gate_silence_device`), on the host
    otherwise (:meth:`_gate_silence`).

    Unlike the JAX package, a failed transcription is not retried on the
    CPU: it raises :class:`~.exceptions.TranscriptionError` (ROADMAP.md
    §C). ``device`` places the model (None: CUDA); the config's
    ``transcription.device`` is not read.
    """

    supports_buffers = True  # reads audio_io.AudioBuffer hand-offs

    def __init__(
        self,
        model_name: str = "large-v3",
        device: Optional[str] = None,
        compute_type: str = "bfloat16",
        beam_size: int = 5,
        language: str = "pt",
        lazy_load: bool = True,
        weights_path: Optional[str] = None,
        batch_size: int = 16,
        vad_filter: bool = True,
        word_timestamps: bool = True,
        chunking: str = "batched",
        max_decode_tokens: int = 224,
        mesh=None,
    ):
        self.model_name = model_name
        self.compute_type = compute_type
        self.beam_size = beam_size
        self.language = language
        self.vad_filter = vad_filter
        self._backend = TorchWhisperBackend(
            model_name=model_name,
            language=language,
            beam_size=beam_size,
            weights_path=weights_path,
            compute_dtype={"float32": "float32", "int8": "int8"}.get(compute_type, "bfloat16"),
            batch_size=batch_size,
            word_timestamps=word_timestamps,
            chunking=chunking,
            max_decode_tokens=max_decode_tokens,
            device=device,
            mesh=mesh,
        )
        self.device = self._backend.device
        if not lazy_load:
            self.load_model()

    @classmethod
    def from_config(cls, config, device: Optional[str] = None) -> "FasterWhisperTranscriber":
        tc = config.transcription
        inst = cls(
            model_name=tc.model,
            device=device,
            compute_type={"float16": "bfloat16"}.get(tc.compute_type, tc.compute_type),
            beam_size=tc.beam_size,
            language=tc.language,
            lazy_load=True,
            weights_path=tc.weights_path,
            batch_size=tc.batch_size,
            word_timestamps=tc.word_timestamps,
            chunking=tc.chunking,
            max_decode_tokens=tc.max_decode_tokens,
            mesh=_mesh_from_config(config, device),
        )
        _configure(inst._backend, tc)
        if not config.lazy_load_models:
            inst.load_model()
        return inst

    def is_loaded(self) -> bool:
        return self._backend.params is not None

    def load_model(self) -> None:
        self._backend.load()

    def unload_model(self) -> None:
        if self.is_loaded():
            self._backend.unload()
            logger.info("FasterWhisper model unloaded")

    def _gate_silence_device(self, dev: torch.Tensor, n_valid: int, sr: int) -> torch.Tensor:
        """Zero the speech-free 30 ms frames of a padded device waveform:
        band statistics to the host, the hangover machine there, the frame
        mask applied on the device."""
        from .ops.vad_ops import band_energies, flags_from_band_stats, hangover_segments

        frame_ms = 30
        frame_len = sr * frame_ms // 1000
        nvf = n_valid // frame_len
        if nvf == 0:
            return dev
        bands_d, db_d = band_energies(dev, sr, frame_ms)
        flags = flags_from_band_stats(bands_d.cpu().numpy()[:nvf], db_d.cpu().numpy()[:nvf], 1)
        segs = hangover_segments(flags, frame_ms, 300, 0.5, 0.9)
        if not segs:
            return dev
        keep = np.zeros(int(dev.shape[-1]) // frame_len, dtype=np.float32)
        for s, e, _ in segs:
            keep[s : e + 1] = 1.0
        keep_t = torch.from_numpy(keep).to(dev.device)
        return (dev.reshape(-1, frame_len) * keep_t[:, None]).reshape(-1)

    def _gate_silence(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Zero the speech-free 30 ms frames of a host waveform."""
        from .ops.vad_ops import frame_speech_flags, hangover_segments

        frame_ms = 30
        flags = frame_speech_flags(audio, sr, frame_ms, 1, device=self.device)
        segs = hangover_segments(flags, frame_ms, 300, 0.5, 0.9)
        if not segs:
            return audio
        keep = np.zeros(len(audio), dtype=bool)
        spf = sr * frame_ms // 1000
        for s, e, _ in segs:
            keep[s * spf : (e + 1) * spf] = True
        return np.where(keep, audio, 0.0).astype(np.float32)

    def transcribe(self, input_wav: str) -> Dict[str, Any]:
        try:
            return self._transcribe_impl(input_wav)
        except (ModelLoadError, NotImplementedError):
            raise
        except Exception as exc:
            raise TranscriptionError(f"Transcription failed for: {input_wav}",
                                     details=str(exc))

    def _transcribe_impl(self, input_wav: str) -> Dict[str, Any]:
        from .audio_io import AudioBuffer

        logger.info("Transcribing (Optimized): %s", input_wav)
        self.load_model()
        buf = get_buffer(input_wav)
        frame_len = _SR * 30 // 1000
        if (buf is not None and buf.tensor is not None and buf.sr == _SR
                and int(buf.tensor.shape[-1]) % frame_len == 0):
            dev = buf.tensor
            if self.vad_filter and buf.n_valid > buf.sr:
                dev = self._gate_silence_device(dev, buf.n_valid, buf.sr)
            return self._backend.transcribe_buffer(
                AudioBuffer(sr=buf.sr, n_valid=buf.n_valid, tensor=dev))
        audio, sr = read_stage_input(input_wav)
        if self.vad_filter and len(audio) > sr:
            audio = self._gate_silence(audio, sr)
        return self._backend.transcribe_array(audio, sr)

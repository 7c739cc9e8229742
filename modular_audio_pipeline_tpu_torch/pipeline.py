"""Pipeline orchestrator: the stage-by-stage run with dependency injection.

Counterpart of ``modular_audio_pipeline_tpu/pipeline.py``, stage for
stage: discover -> convert -> denoise -> separate -> normalize ->
loudness -> silence removal -> VAD -> transcribe -> diarize -> align ->
timestamp back-mapping -> redundancy -> merge -> optional LLM analysis ->
JSON, with the same
component selection (an injected stage, else the first-party one, else
its NoOp when the config turns it off), the same failure-to-
``PipelineResult`` policy, the same output JSON schema, and per-stage
wall-clock timings in ``PipelineResult.metadata["stage_timings"]``.

First-party stages hand each other padded device tensors
(``audio_io.publish_buffer``), so the waveform is uploaded once and stays
on the device from the denoise to the transcriber and the diarizer; a
WAV is still written at every stage boundary, on a worker thread. Every
stage runs on ``device`` (None: CUDA, raising without one).

A ``tpu.mesh_shape`` axis above 1 runs the transcriber under a mesh (one
process per card, ``parallel/mesh.py``), which it builds in its
``from_config``, as in the JAX package; every other stage runs
replicated on every rank. Rank 0 alone writes the JSON and the stage
checkpoints; another rank keeps its stage WAVs and conversions in a
``<temp_dir>.rank<r>`` directory of its own. With ``llm.enabled`` the
hybrid post-processor (``post_processing_hybrid``; a local LM runs on
``device``) analyses the final text, best effort as in the JAX package. As
in the JAX package, ``SegmentMerger`` builds new segments without
``original_start``/``original_end``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

from .config import PipelineConfig, get_default_config
from .diarizer import NoOpDiarizer, SpeakerDiarizer
from .exceptions import AudioPipelineError, MediaNotFoundError
from .media_handler import MediaHandler
from .preprocessor import AudioPreprocessor
from .protocols import (
    DiarizationSegment,
    DiarizerProtocol,
    MediaHandlerProtocol,
    PreprocessorProtocol,
    RedundancyRemoverProtocol,
    TimestampMapping,
    TranscriberProtocol,
    VADProtocol,
    VocalSeparatorProtocol,
)
from .redundancy import NoOpRedundancyRemover, RedundancyRemover
from .segment_merger import SegmentMerger
from .separator import NoOpVocalSeparator, VocalSeparator
from .parallel.mesh import rank_dir, world_rank
from .transcriber import FasterWhisperTranscriber, WhisperTranscriber
from .utils import (
    CheckpointManager,
    ensure_directory,
    get_audio_duration,
    resolve_device,
)
from .vad import NoOpVADFilter, SileroVADFilter, VADFilter

logger = logging.getLogger(__name__)

__all__ = ["AudioPipeline", "PipelineResult"]


@dataclass
class PipelineResult:
    """Outcome of one pipeline run."""

    success: bool
    input_file: str
    output_file: Optional[str]
    segments: List[Dict[str, Any]]
    error: Optional[str] = None
    metadata: Dict[str, Any] = None
    llm_analysis: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.metadata is None:
            self.metadata = {}


class _StageTimer:
    """Collects per-stage wall-clock timings for the run metadata."""

    def __init__(self):
        self.timings: Dict[str, float] = {}

    def measure(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer.timings[name] = round(
                    timer.timings.get(name, 0.0) + time.perf_counter() - self.t0, 4
                )

        return _Ctx()


class AudioPipeline:
    """Coordinates the full pipeline; components injectable via protocols."""

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        media_handler: Optional[MediaHandlerProtocol] = None,
        preprocessor: Optional[PreprocessorProtocol] = None,
        separator: Optional[VocalSeparatorProtocol] = None,
        vad: Optional[VADProtocol] = None,
        transcriber: Optional[TranscriberProtocol] = None,
        diarizer: Optional[DiarizerProtocol] = None,
        redundancy_remover: Optional[RedundancyRemoverProtocol] = None,
        device=None,
    ):
        self.config = config or get_default_config()
        self.config.validate()
        self.device = resolve_device(device)

        self.media_dir = ensure_directory(self.config.media_dir)
        # under a mesh every rank runs the stages: rank 0 writes the results
        # and the checkpoints, another rank's stage files stay its own
        self.temp_dir = ensure_directory(rank_dir(self.config.temp_dir))
        self.results_dir = ensure_directory(self.config.results_dir)
        self._writer = world_rank() == 0

        self.checkpoint_manager: Optional[CheckpointManager] = None
        if self.config.checkpoint_enabled and self._writer:
            self.checkpoint_manager = CheckpointManager(self.temp_dir)

        # -- component wiring: an injected stage, else the first-party one,
        # else its NoOp when the config turns the stage off
        dev = self.device
        self.media = media_handler or MediaHandler.from_config(self.config)
        self.preprocessor = preprocessor or AudioPreprocessor.from_config(self.config, device=dev)

        if separator:
            self.separator = separator
        elif self.config.vocal_separation.enabled:
            self.separator = VocalSeparator.from_config(
                self.config, self.checkpoint_manager, device=dev)
        else:
            self.separator = NoOpVocalSeparator()

        if vad:
            self.vad = vad
        elif self.config.vad.enabled:
            if self.config.vad.provider == "silero":
                logger.info("Using Silero-class VAD (DNN/energy)")
                self.vad = SileroVADFilter(
                    threshold=self.config.vad.threshold,
                    sampling_rate=self.config.audio.sample_rate,
                    min_speech_duration_ms=self.config.vad.min_speech_duration_ms,
                    device=dev,
                )
            else:
                logger.info("Using WebRTC-class VAD (frame machine)")
                self.vad = VADFilter.from_config(self.config, device=dev)
        else:
            self.vad = NoOpVADFilter()

        if transcriber:
            self.transcriber = transcriber
        elif self.config.transcription.backend == "faster-whisper":
            logger.info("Using FasterWhisper-class transcriber (optimized)")
            self.transcriber = FasterWhisperTranscriber.from_config(self.config, device=dev)
        else:
            logger.info("Using standard Whisper-class transcriber")
            self.transcriber = WhisperTranscriber.from_config(self.config, device=dev)

        if diarizer:
            self.diarizer = diarizer
        elif self.config.diarization.enabled:
            self.diarizer = SpeakerDiarizer.from_config(self.config, device=dev)
        else:
            self.diarizer = NoOpDiarizer()

        if redundancy_remover:
            self.redundancy = redundancy_remover
        elif self.config.redundancy.enabled:
            self.redundancy = RedundancyRemover.from_config(self.config)
        else:
            self.redundancy = NoOpRedundancyRemover()

        # the LLM post-processor: best effort, never fatal (as the JAX package)
        self.llm_processor = None
        if self.config.llm.enabled:
            try:
                from .post_processing_hybrid import HybridLLMPostProcessor

                self.llm_processor = HybridLLMPostProcessor(
                    device=self.config.llm.device,
                    max_length=self.config.llm.max_length,
                    temperature=self.config.llm.temperature,
                    force_local=not self.config.llm.use_openai,
                    openai_model=self.config.llm.openai_model,
                    local_model=self.config.llm.local_model,
                    lm_device=dev,
                )
                info = self.llm_processor.get_backend_info()
                logger.info("LLM initialized: %s (%s)", info["backend"], info["model"])
            except Exception as exc:
                logger.error("Failed to initialize LLM: %s", exc)
                self.llm_processor = None

        self._timestamp_mappings: List[TimestampMapping] = []

    # -- pure helpers ---------------------------------------------------------

    @staticmethod
    def _map_timestamp_to_original(
        processed_time: float, mappings: List[TimestampMapping]
    ) -> float:
        """Linear interpolation inside the containing mapping interval;
        identity when no interval contains the time."""
        if not mappings:
            return processed_time
        for m in mappings:
            if m.processed_start <= processed_time <= m.processed_end:
                ratio = (processed_time - m.processed_start) / (
                    m.processed_end - m.processed_start + 1e-10
                )
                return m.original_start + ratio * (m.original_end - m.original_start)
        return processed_time

    @staticmethod
    def _align_transcription_with_speakers(
        transcription_segments: List[Dict],
        diarization_segments: List[DiarizationSegment],
    ) -> List[Dict]:
        """Max-overlap speaker attribution; segments without text dropped."""
        aligned = []
        for seg in transcription_segments:
            start, end = seg["start"], seg["end"]
            text = seg.get("text", "").strip()
            if not text:
                continue

            speaker = "Unknown"
            best_overlap = 0.0
            for d in diarization_segments:
                overlap = max(0.0, min(end, d.end) - max(start, d.start))
                if overlap > best_overlap:
                    best_overlap = overlap
                    speaker = d.speaker

            aligned.append(
                {"speaker": speaker, "start": start, "end": end, "text": text}
            )
        return aligned

    # -- main entry -------------------------------------------------------------

    def run(self, input_file: Optional[str] = None) -> PipelineResult:
        """Execute the full pipeline; never raises: failures come back as
        ``PipelineResult(success=False)``. With ``tpu.profile_dir`` set, the
        run is traced by ``torch.profiler`` into a Chrome trace there."""
        profile_dir = self.config.tpu.profile_dir
        if not profile_dir:
            return self._run_impl(input_file)
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            result = self._run_impl(input_file)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"pipeline_{int(time.time())}.json"))
        return result

    @staticmethod
    def _handoff(path: str, component) -> str:
        """Stage hand-off: first-party components exchange in-memory
        AudioBuffers keyed by ``path`` (WAV checkpoints are written
        asynchronously); before a component that is not buffer-aware (an
        injected one, a NoOp) reads ``path``, its pending write must
        complete."""
        if not getattr(component, "supports_buffers", False):
            from .audio_io import flush_writes

            flush_writes(path)
        return path

    def _run_impl(self, input_file: Optional[str] = None) -> PipelineResult:
        from .audio_io import (
            begin_async_run,
            clear_buffers,
            end_async_run,
            flush_writes,
        )

        timer = _StageTimer()
        run_start = time.perf_counter()
        clear_buffers()  # fresh buffer registry per file
        # With checkpointing disabled, temp-dir stage WAVs (scratch that
        # cleanup() deletes) are written only if something reads them.
        begin_async_run(
            lazy_prefix=None if self.config.checkpoint_enabled else self.temp_dir
        )
        try:
            # 1. discover
            with timer.measure("discover"):
                if input_file:
                    media_file, is_video = self.media.find_specific_file(input_file)
                else:
                    media_file, is_video = self.media.find_media_file()
            base = Path(media_file).stem
            logger.info("Processing: %s", media_file)

            # 2. convert
            with timer.measure("convert"):
                ext = Path(media_file).suffix.lower()
                if is_video or ext != ".wav":
                    wav = self.media.convert_to_wav(media_file)
                else:
                    wav = media_file

            all_mappings: List[TimestampMapping] = []

            # 3a. denoise
            if self.config.noise_reduction.enabled:
                logger.info("Reducing noise...")
                with timer.measure("denoise"):
                    denoised = self.preprocessor.reduce_stationary_noise(wav)
            else:
                denoised = wav

            # 3b. vocal separation (auto-detect gates execution)
            if self.config.vocal_separation.enabled or self.config.vocal_separation.auto_detect:
                logger.info("Checking if vocal separation needed...")
                with timer.measure("separate"):
                    vocals = self.separator.extract_vocals(
                        self._handoff(denoised, self.separator)
                    )
            else:
                vocals = denoised

            # 3c. normalize + loudness
            logger.info("Normalizing audio...")
            with timer.measure("normalize"):
                norm = self.preprocessor.normalize_audio(vocals)
                loudnorm = self.preprocessor.normalize_loudness(norm)

            # 3d. silence removal
            with timer.measure("silence"):
                if self.config.preserve_timestamps:
                    logger.info("Removing silence (preserving timestamps)...")
                    silence_removed, silence_mappings = self.preprocessor.remove_silence(
                        loudnorm, preserve_timestamps=True
                    )
                    all_mappings.extend(silence_mappings)
                else:
                    silence_removed, _ = self.preprocessor.remove_silence(loudnorm)

            # 4. VAD
            if self.config.vad.enabled:
                logger.info("Applying VAD (%s)...", self.config.vad.provider)
                with timer.measure("vad"):
                    voiced_wav, vad_mappings = self.vad.filter_voice(
                        self._handoff(silence_removed, self.vad), self.results_dir
                    )
                if self.config.preserve_timestamps:
                    all_mappings.extend(vad_mappings)
            else:
                voiced_wav = silence_removed

            # 5. transcribe
            logger.info("Transcribing (%s)...", self.config.transcription.backend)
            with timer.measure("transcribe"):
                transcription = self.transcriber.transcribe(
                    self._handoff(voiced_wav, self.transcriber)
                )
            raw_segments = transcription.get("segments", [])
            logger.info("Transcribed %d segments", len(raw_segments))

            # 6. diarize
            if self.config.diarization.enabled:
                logger.info("Diarizing speakers...")
                with timer.measure("diarize"):
                    diarization_segments = self.diarizer.diarize(
                        self._handoff(voiced_wav, self.diarizer),
                        min_speakers=self.config.diarization.min_speakers,
                        max_speakers=self.config.diarization.max_speakers,
                    )
            else:
                diarization_segments = []

            # 7. align
            logger.info("Aligning transcription with speakers...")
            aligned = self._align_transcription_with_speakers(
                raw_segments, diarization_segments
            )

            # 8. map timestamps back to the original timeline
            if self.config.preserve_timestamps and all_mappings:
                logger.info("Mapping timestamps to original audio...")
                for seg in aligned:
                    seg["original_start"] = self._map_timestamp_to_original(
                        seg["start"], all_mappings
                    )
                    seg["original_end"] = self._map_timestamp_to_original(
                        seg["end"], all_mappings
                    )

            # 9. redundancy
            logger.info("Removing redundant segments...")
            final_segments = self.redundancy.remove(aligned)
            logger.info("Final: %d segments", len(final_segments))

            # 10. merge
            if self.config.segment_merging.enabled:
                logger.info("Merging short segments...")
                merger = SegmentMerger(max_gap_s=self.config.segment_merging.max_gap_s)
                final_segments = merger.merge(final_segments)

            # 11a. LLM analysis (optional, never fatal)
            llm_analysis = None
            if self.llm_processor:
                try:
                    logger.info("Analyzing with LLM...")
                    with timer.measure("llm"):
                        full_text = " ".join(s["text"] for s in final_segments)
                        llm_analysis = self.llm_processor.process(full_text)
                    if "error" not in llm_analysis:
                        logger.info("LLM analysis complete")
                    else:
                        logger.warning("LLM analysis failed: %s", llm_analysis["error"])
                except Exception as exc:
                    logger.warning("LLM processing failed: %s", exc)
                    llm_analysis = {"error": str(exc)}

            # 11b. serialize
            flush_writes()  # all WAV checkpoints on disk before we report
            wall = time.perf_counter() - run_start
            try:
                audio_duration = get_audio_duration(wav)
            except Exception:
                audio_duration = 0.0

            output_data = {
                "metadata": {
                    "source_file": str(media_file),
                    "config": {
                        "model": self.config.transcription.model,
                        "language": self.config.transcription.language,
                        "vad_provider": self.config.vad.provider,
                        "transcription_backend": self.config.transcription.backend,
                    },
                },
                "segments": final_segments,
            }
            if llm_analysis and "error" not in llm_analysis:
                output_data["llm_analysis"] = llm_analysis

            out_path = os.path.join(self.results_dir, f"{base}_transcription.json")
            if self._writer:
                with open(out_path, "w", encoding="utf-8") as f:
                    json.dump(output_data, f, ensure_ascii=False, indent=2)
                logger.info("Saved transcription: %s", out_path)

            return PipelineResult(
                success=True,
                input_file=str(media_file),
                output_file=out_path,
                segments=final_segments,
                llm_analysis=llm_analysis,
                metadata={
                    "model": self.config.transcription.model,
                    "backend": self.config.transcription.backend,
                    "vad": self.config.vad.provider,
                    "llm_enabled": self.config.llm.enabled,
                    "stage_timings": timer.timings,
                    "wall_time_s": round(wall, 3),
                    "audio_duration_s": round(audio_duration, 3),
                    "rtf": round(audio_duration / wall, 2) if wall > 0 else None,
                },
            )

        except MediaNotFoundError as exc:
            logger.error("Media not found: %s", exc)
            return self._failure(input_file, str(exc))
        except AudioPipelineError as exc:
            logger.error("Pipeline error: %s", exc)
            return self._failure(input_file, str(exc))
        except Exception as exc:
            logger.exception("Unexpected error: %s", exc)
            return self._failure(input_file, f"Unexpected error: {exc}")
        finally:
            end_async_run()  # idempotent with the explicit flush above

    @staticmethod
    def _failure(input_file: Optional[str], error: str) -> PipelineResult:
        return PipelineResult(
            success=False,
            input_file=str(input_file) if input_file else "",
            output_file=None,
            segments=[],
            error=error,
        )

    def run_transcription_only(self, input_wav: str) -> PipelineResult:
        """Transcribe a pre-processed WAV, skipping every other stage."""
        try:
            result = self.transcriber.transcribe(input_wav)
            return PipelineResult(
                success=True,
                input_file=input_wav,
                output_file=None,
                segments=result.get("segments", []),
            )
        except Exception as exc:
            return PipelineResult(
                success=False,
                input_file=input_wav,
                output_file=None,
                segments=[],
                error=str(exc),
            )

    def cleanup(self) -> None:
        """Unload models, clear checkpoints, delete temp files."""
        import shutil

        from .audio_io import clear_buffers

        logger.info("Cleaning up...")
        clear_buffers()
        if hasattr(self.transcriber, "unload_model"):
            self.transcriber.unload_model()
        if hasattr(self.diarizer, "unload_model"):
            self.diarizer.unload_model()
        if self.checkpoint_manager:
            self.checkpoint_manager.clear()
        if os.path.exists(self.temp_dir):
            shutil.rmtree(self.temp_dir)
            logger.info("Cleaned up temp directory: %s", self.temp_dir)

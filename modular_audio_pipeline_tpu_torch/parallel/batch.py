"""Multi-file batch driver: checkpointed, resumable directory processing.

Counterpart of ``modular_audio_pipeline_tpu/parallel/batch.py``:

- every media file in ``media_dir`` (sorted, as discovery sorts),
- a per-file status ledger (``results_dir/batch_status.json``) keyed by
  ``name:content-hash`` and saved atomically after every file, so an
  interrupted run resumes where it stopped: a file whose entry succeeded
  and whose output still exists is skipped,
- ``run()``: the full ``AudioPipeline`` per file, one instance across
  the directory; ``run(serving=True)``: ``ServingPipeline.run_file`` per
  file with the next WAV decoded on a prefetch thread, other files
  converted to WAV by the media handler first.

Runs on CUDA unless ``device="cpu"``. Under a mesh (``tpu.mesh_shape``,
one process per card under ``torchrun``) every rank walks the same file
list and runs the same pipeline, whose transcriber shards the window
batches; rank 0 alone writes the ledger, the JSON outputs and the
checkpoints, and a barrier after each file keeps the ranks in step, so
every rank reads the same ledger when a run resumes.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, List

from ..config import PipelineConfig
from ..media_handler import MediaHandler
from ..parallel.mesh import world_rank
from ..utils import ensure_directory, get_file_hash, resolve_device

logger = logging.getLogger(__name__)

__all__ = ["BatchDriver"]


class BatchDriver:
    """Run the full pipeline over every media file in a directory."""

    STATUS_FILE = "batch_status.json"

    def __init__(self, config: PipelineConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        ensure_directory(config.results_dir)
        self.status_path = Path(config.results_dir) / self.STATUS_FILE
        self._status: Dict[str, Dict[str, Any]] = {}
        self._load_status()

    # -- ledger ---------------------------------------------------------------

    def _load_status(self) -> None:
        if self.status_path.exists():
            try:
                self._status = json.loads(self.status_path.read_text())
            except Exception as exc:
                logger.warning("Could not read batch status: %s", exc)
                self._status = {}

    def _save_status(self) -> None:
        """Write the ledger (rank 0 under a mesh), then wait for every rank:
        one barrier per file."""
        if world_rank() == 0:
            tmp = self.status_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self._status, indent=2))
            os.replace(tmp, self.status_path)
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def _file_key(self, path: str) -> str:
        return f"{Path(path).name}:{get_file_hash(path)}"

    # -- enumeration -------------------------------------------------------------

    def list_media_files(self) -> List[str]:
        media_dir = self.config.media_dir
        exts = MediaHandler.AUDIO_EXTENSIONS | MediaHandler.VIDEO_EXTENSIONS
        out = []
        for fname in sorted(os.listdir(media_dir)):
            full = os.path.join(media_dir, fname)
            if os.path.isfile(full) and Path(fname).suffix.lower() in exts:
                out.append(full)
        return out

    # -- main loop -----------------------------------------------------------------

    def run(self, cleanup_per_file: bool = False, serving: bool = False) -> Dict[str, Any]:
        if serving:
            return self._run_serving()
        from ..pipeline import AudioPipeline

        files = self.list_media_files()
        logger.info("Batch: %d media files in %s", len(files), self.config.media_dir)

        succeeded = failed = skipped = 0
        audio_seconds = 0.0
        wall_start = time.perf_counter()

        # One pipeline instance: models stay loaded across files.
        pipeline = AudioPipeline(self.config, device=self.device)

        for path in files:
            key = self._file_key(path)
            prior = self._status.get(key)
            if prior and prior.get("success") and os.path.exists(
                prior.get("output_file") or ""
            ):
                logger.info("Skipping (already done): %s", Path(path).name)
                skipped += 1
                audio_seconds += prior.get("audio_duration_s", 0.0)
                continue

            logger.info("Processing %s ...", Path(path).name)
            t0 = time.perf_counter()
            result = pipeline.run(input_file=path)
            elapsed = time.perf_counter() - t0

            entry = {
                "success": result.success,
                "output_file": result.output_file,
                "error": result.error,
                "wall_time_s": round(elapsed, 3),
                "audio_duration_s": result.metadata.get("audio_duration_s", 0.0),
                "rtf": result.metadata.get("rtf"),
                "finished_at": time.time(),
            }
            self._status[key] = entry
            self._save_status()

            if result.success:
                succeeded += 1
                audio_seconds += entry["audio_duration_s"] or 0.0
            else:
                failed += 1
                logger.error("Failed: %s (%s)", Path(path).name, result.error)

            if cleanup_per_file:
                pipeline.cleanup()
                pipeline = AudioPipeline(self.config, device=self.device)

        wall = time.perf_counter() - wall_start
        summary = {
            "total": len(files),
            "succeeded": succeeded,
            "failed": failed,
            "skipped": skipped,
            "audio_seconds": round(audio_seconds, 1),
            "wall_time_s": round(wall, 1),
            "throughput_audio_hours_per_hour": (
                round(audio_seconds / wall, 2)
                if wall > 1.0 and (succeeded or failed)
                else None
            ),
        }
        logger.info("Batch summary: %s", summary)
        return summary

    def _run_serving(self) -> Dict[str, Any]:
        """Serving-path batch: the device-resident pipeline + file prefetch.

        The next file's read/decode overlaps the current file's device
        work (runtime.prefetch); models stay loaded across the whole
        directory. Same resume ledger as the standard path. Files other
        than WAV are converted by the media handler first.
        """
        from ..runtime.prefetch import AudioPrefetcher
        from ..serving import ServingPipeline

        files = self.list_media_files()
        logger.info(
            "Serving batch: %d media files in %s", len(files), self.config.media_dir
        )

        todo: List[str] = []
        skipped = 0
        audio_seconds = 0.0
        for path in files:
            prior = self._status.get(self._file_key(path))
            if prior and prior.get("success") and os.path.exists(
                prior.get("output_file") or ""
            ):
                skipped += 1
                audio_seconds += prior.get("audio_duration_s", 0.0)
            else:
                todo.append(path)

        serving = ServingPipeline(self.config, device=self.device)
        succeeded = failed = 0
        wall_start = time.perf_counter()

        def load(path: str):
            # decode + resample on the prefetch thread; mono 16-bit PCM at
            # the target rate stays int16 (half the host-to-device bytes,
            # converted to f32 on the device by serving.process)
            from ..audio_io import read_wav, read_wav_raw_int16, resample_poly

            target = self.config.audio.sample_rate
            raw, sr = read_wav_raw_int16(path)
            if raw is not None and sr == target:
                return raw, sr
            audio, sr = read_wav(path)
            if sr != target:
                audio = resample_poly(audio, sr, target)
                sr = target
            return audio, sr

        wav_todo = [p for p in todo if p.lower().endswith(".wav")]
        other = [p for p in todo if not p.lower().endswith(".wav")]
        if other:
            logger.info("%d non-WAV files take the standard conversion path", len(other))

        for path, audio, sr, err in AudioPrefetcher(wav_todo, loader=load):
            if err is not None:
                failed += 1
                self._status[self._file_key(path)] = {
                    "success": False, "error": str(err), "finished_at": time.time(),
                }
                self._save_status()
                continue
            t0 = time.perf_counter()
            try:
                pipeline_result = serving.run_file(
                    path, results_dir=self.config.results_dir, audio=audio, sr=sr
                )
                ok = pipeline_result.success
                entry = {
                    "success": ok,
                    "output_file": pipeline_result.output_file,
                    "error": pipeline_result.error,
                    "wall_time_s": round(time.perf_counter() - t0, 3),
                    "audio_duration_s": pipeline_result.metadata.get(
                        "audio_duration_s", 0.0
                    ),
                    "rtf": pipeline_result.metadata.get("rtf"),
                    "finished_at": time.time(),
                }
            except Exception as exc:
                ok = False
                entry = {
                    "success": False, "error": str(exc),
                    "wall_time_s": round(time.perf_counter() - t0, 3),
                    "finished_at": time.time(),
                }
            self._status[self._file_key(path)] = entry
            self._save_status()
            if ok:
                succeeded += 1
                audio_seconds += entry.get("audio_duration_s", 0.0)
            else:
                failed += 1

        # non-WAV files: conversion + serving file path
        media = MediaHandler.from_config(self.config)
        for path in other:
            t0 = time.perf_counter()
            try:
                wav = media.convert_to_wav(path)
                pipeline_result = serving.run_file(wav, results_dir=self.config.results_dir)
                ok = pipeline_result.success
            except Exception as exc:
                ok = False
                pipeline_result = None
                logger.error("Failed: %s (%s)", Path(path).name, exc)
            entry = {
                "success": ok,
                "output_file": getattr(pipeline_result, "output_file", None),
                "error": getattr(pipeline_result, "error", None),
                "wall_time_s": round(time.perf_counter() - t0, 3),
                "audio_duration_s": (
                    pipeline_result.metadata.get("audio_duration_s", 0.0)
                    if ok else 0.0
                ),
                "finished_at": time.time(),
            }
            self._status[self._file_key(path)] = entry
            self._save_status()
            succeeded += 1 if ok else 0
            failed += 0 if ok else 1

        wall = time.perf_counter() - wall_start
        summary = {
            "total": len(files),
            "succeeded": succeeded,
            "failed": failed,
            "skipped": skipped,
            "audio_seconds": round(audio_seconds, 1),
            "wall_time_s": round(wall, 1),
            "throughput_audio_hours_per_hour": (
                round(audio_seconds / wall, 2)
                if wall > 1.0 and (succeeded or failed)
                else None
            ),
        }
        logger.info("Serving batch summary: %s", summary)
        return summary

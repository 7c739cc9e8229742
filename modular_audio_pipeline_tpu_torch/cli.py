"""Command-line entry point of the PyTorch port.

``python -m modular_audio_pipeline_tpu_torch`` takes the flags of the
repository's ``main.py`` (the JAX package's CLI) and returns its exit
codes: 0 success, 1 error, 130 interrupted. The work runs on CUDA;
:func:`main` takes ``device`` for callers that want the CPU (the tests).
``--devices``/``--tp`` set ``tpu.mesh_shape`` and run under ``torchrun``,
one process per card::

    torchrun --nproc-per-node 4 -m modular_audio_pipeline_tpu_torch \
        --media-dir media --batch --serving --devices 4 --tp 2

A mesh larger or smaller than the world of ranks exits 1 through
``ShardingError``.
"""

from __future__ import annotations

import argparse
import logging
import os

from .config import DEFAULT_PROMPTS, PipelineConfig, get_default_config
from .exceptions import AudioPipelineError, ConfigurationError

logger = logging.getLogger(__name__)

__all__ = ["main", "parse_args", "build_config"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m modular_audio_pipeline_tpu_torch",
        description="Audio Processing & Transcription Pipeline (PyTorch/CUDA)",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""
Examples:
  # Process audio in default directory with defaults
  python -m modular_audio_pipeline_tpu_torch

  # Process specific directory with custom model
  python -m modular_audio_pipeline_tpu_torch --media-dir ./recordings --model large-v3

  # Process single file with English transcription
  python -m modular_audio_pipeline_tpu_torch --input recording.mp3 --language en

  # Use configuration file
  python -m modular_audio_pipeline_tpu_torch --config config.json

  # Disable diarization for single speaker
  python -m modular_audio_pipeline_tpu_torch --no-diarization

  # Enable vocal separation for audio with music
  python -m modular_audio_pipeline_tpu_torch --separate-vocals

  # Batch-process a directory (checkpointed, resumable)
  python -m modular_audio_pipeline_tpu_torch --batch --media-dir ./lectures
        """,
    )

    input_group = parser.add_argument_group("Input Options")
    input_group.add_argument("--media-dir", "-d", type=str,
                             help="Directory containing media files (default: ./files)")
    input_group.add_argument("--input", "-i", type=str,
                             help="Specific input file to process")
    input_group.add_argument("--config", "-c", type=str,
                             help="Path to JSON configuration file")

    trans_group = parser.add_argument_group("Transcription Options")
    trans_group.add_argument(
        "--model", "-m", type=str,
        choices=["tiny", "base", "small", "medium", "large", "large-v2",
                 "large-v3", "large-v3-turbo", "test-tiny"],
        help="Whisper model to use (default: large-v3-turbo)",
    )
    trans_group.add_argument("--language", "-l", type=str,
                             help="Language code for transcription (default: pt)")
    trans_group.add_argument("--prompt", "-p", type=str,
                             help="Initial prompt to guide transcription")
    trans_group.add_argument("--prompt-preset", type=str,
                             choices=list(DEFAULT_PROMPTS.keys()),
                             help="Use a preset prompt")
    trans_group.add_argument("--weights-dir", type=str,
                             help="Converted checkpoint directory (or 'random:SEED')")
    trans_group.add_argument("--batch-size", type=int,
                             help="30s windows decoded per device batch")
    trans_group.add_argument("--patience", type=float,
                             help="Beam search patience (finished-pool "
                                  "factor, faster-whisper semantics)")

    proc_group = parser.add_argument_group("Processing Options")
    proc_group.add_argument("--separate-vocals", action="store_true",
                            help="Enable vocal separation (useful for audio with music)")
    proc_group.add_argument("--auto-separate", action="store_true",
                            help="Auto-detect if vocal separation is needed")
    proc_group.add_argument("--no-diarization", action="store_true",
                            help="Disable speaker diarization")
    proc_group.add_argument("--no-vad", action="store_true",
                            help="Disable Voice Activity Detection")
    proc_group.add_argument("--no-noise-reduction", action="store_true",
                            help="Disable noise reduction")
    proc_group.add_argument("--min-speakers", type=int,
                            help="Minimum expected number of speakers (default: 1)")
    proc_group.add_argument("--max-speakers", type=int,
                            help="Maximum expected number of speakers (default: 5)")
    proc_group.add_argument("--batch", action="store_true",
                            help="Process every media file in --media-dir "
                                 "(checkpointed, resumable)")
    proc_group.add_argument("--serving", action="store_true",
                            help="Device-resident fast path (one upload, "
                                 "stats-only downloads; skips crossfades)")
    proc_group.add_argument("--devices", type=int,
                            help="Shard batch work over this many devices "
                                 "(one process per card under torchrun)")
    proc_group.add_argument("--tp", type=int,
                            help="Tensor-parallel ways (Megatron-style "
                                 "'model' mesh axis; combines with --devices "
                                 "for the data axis)")

    output_group = parser.add_argument_group("Output Options")
    output_group.add_argument("--output-dir", "-o", type=str,
                              help="Directory for output files")
    output_group.add_argument("--preserve-timestamps", action="store_true",
                              default=True,
                              help="Preserve original timestamps (default: True)")

    debug_group = parser.add_argument_group("Debug Options")
    debug_group.add_argument("--verbose", "-v", action="store_true",
                             help="Enable verbose logging")
    debug_group.add_argument("--debug", action="store_true",
                             help="Enable debug logging")
    debug_group.add_argument("--no-cleanup", action="store_true",
                             help="Don't cleanup temporary files after processing")
    debug_group.add_argument("--profile-dir", type=str,
                             help="Write a torch.profiler trace to this directory")

    return parser.parse_args(argv)


def build_config(args: argparse.Namespace) -> PipelineConfig:
    """CLI > JSON file > defaults."""
    if args.config and os.path.exists(args.config):
        config = PipelineConfig.from_json(args.config)
        logger.info("Loaded configuration from: %s", args.config)
    else:
        config = get_default_config()

    if args.media_dir:
        config.media_dir = args.media_dir
        # Re-derive temp/results under the new media dir (unless the config
        # file pinned them explicitly, which --output-dir can still override).
        config.temp_dir = None
        config.results_dir = None
    if args.output_dir:
        config.results_dir = args.output_dir

    if args.model:
        config.transcription.model = args.model
    if args.language:
        config.transcription.language = args.language
    if args.prompt:
        config.transcription.prompt = args.prompt
    elif args.prompt_preset:
        config.transcription.prompt = DEFAULT_PROMPTS[args.prompt_preset]
    if args.weights_dir:
        config.transcription.weights_path = args.weights_dir
    if args.batch_size:
        config.transcription.batch_size = args.batch_size
    if args.patience is not None:
        config.transcription.patience = args.patience

    if args.separate_vocals:
        config.vocal_separation.enabled = True
    if args.auto_separate:
        config.vocal_separation.auto_detect = True
    if args.no_diarization:
        config.diarization.enabled = False
    if args.no_vad:
        config.vad.enabled = False
    if args.no_noise_reduction:
        config.noise_reduction.enabled = False
    if args.min_speakers:
        config.diarization.min_speakers = args.min_speakers
    if args.max_speakers:
        config.diarization.max_speakers = args.max_speakers
    if args.devices:
        config.tpu.mesh_shape = {"data": args.devices}
    if args.tp and args.tp > 1:
        data = max(1, (args.devices or args.tp) // args.tp)
        config.tpu.mesh_shape = {"data": data, "model": args.tp}
    if args.profile_dir:
        config.tpu.profile_dir = args.profile_dir

    config.preserve_timestamps = args.preserve_timestamps
    config.__post_init__()
    return config


def main(argv=None, device=None) -> int:
    """Run the CLI; returns the exit code (0 success, 1 error, 130
    interrupted). ``device`` places the work (None: CUDA); it is not a
    flag, as the JAX CLI has none."""
    args = parse_args(argv)

    if args.debug:
        logging.getLogger().setLevel(logging.DEBUG)
    elif args.verbose:
        logging.getLogger().setLevel(logging.INFO)

    try:
        config = build_config(args)

        logger.info("Media directory: %s", config.media_dir)
        logger.info("Model: %s", config.transcription.model)
        logger.info("Language: %s", config.transcription.language)

        if args.batch:
            from .parallel.batch import BatchDriver

            driver = BatchDriver(config, device=device)
            summary = driver.run(serving=args.serving)
            ok = summary["failed"] == 0
            logger.info(
                "Batch complete: %d ok, %d failed, %.1f audio-min processed",
                summary["succeeded"], summary["failed"],
                summary["audio_seconds"] / 60,
            )
            return 0 if ok else 1

        if args.serving:
            from .media_handler import MediaHandler
            from .serving import ServingPipeline

            media = MediaHandler.from_config(config)
            if args.input:
                media_file, is_video = media.find_specific_file(args.input)
            else:
                media_file, is_video = media.find_media_file()
            if is_video or not media_file.lower().endswith(".wav"):
                media_file = media.convert_to_wav(media_file)
            serving = ServingPipeline(config, device=device)
            result = serving.run_file(media_file, results_dir=config.results_dir)
            if result.success:
                logger.info("Serving path complete!")
                logger.info("  Output: %s", result.output_file)
                logger.info("  Segments: %d", len(result.segments))
                if result.metadata.get("rtf"):
                    logger.info("  Realtime factor: %.1fx", result.metadata["rtf"])
                return 0
            logger.error("Processing failed: %s", result.error)
            return 1

        from .pipeline import AudioPipeline

        pipeline = AudioPipeline(config, device=device)
        result = pipeline.run(input_file=args.input)

        if result.success:
            logger.info("Processing complete!")
            logger.info("  Input: %s", result.input_file)
            logger.info("  Output: %s", result.output_file)
            logger.info("  Segments: %d", len(result.segments))
            if result.metadata.get("rtf"):
                logger.info("  Realtime factor: %.1fx", result.metadata["rtf"])
            if not args.no_cleanup:
                pipeline.cleanup()
            return 0
        logger.error("Processing failed: %s", result.error)
        return 1

    except ConfigurationError as exc:
        logger.error("Configuration error: %s", exc)
        return 1
    except AudioPipelineError as exc:
        logger.error("Pipeline error: %s", exc)
        return 1
    except KeyboardInterrupt:
        logger.info("Processing interrupted by user")
        return 130
    except Exception as exc:
        logger.exception("Unexpected error: %s", exc)
        return 1

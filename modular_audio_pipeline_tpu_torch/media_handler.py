"""Media discovery and conversion to pipeline-format WAV.

Copied from ``modular_audio_pipeline_tpu/media_handler.py``: audio
preferred over video, sorted order, a 100-byte minimum, the temp dir
wiped on discovery. WAV, FLAC and MP3 decode in-process (the RIFF codec,
the C++ FLAC and Layer III decoders of the port's own native library,
``runtime/native/``), other containers through the libav shim where the
system libavformat/libavcodec are installed, and an FFmpeg binary on
PATH is the last resort. Everything is resampled on the host (scipy) to
mono 16-bit WAV at the configured rate.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Set, Tuple

from .audio_io import read_wav, resample_poly, wav_info, write_wav
from .config import PipelineConfig, RetryConfig
from .exceptions import FileValidationError, MediaConversionError, MediaNotFoundError
from .protocols import MediaHandlerProtocol
from .utils import retry_with_backoff, validate_file

logger = logging.getLogger(__name__)

__all__ = ["MediaHandler"]


class MediaHandler(MediaHandlerProtocol):
    """Finds media files and converts them to mono 16-bit WAV."""

    AUDIO_EXTENSIONS: Set[str] = {
        ".mp3", ".m4a", ".wav", ".ogg", ".flac", ".aac", ".wma", ".opus",
    }
    VIDEO_EXTENSIONS: Set[str] = {
        ".mp4", ".avi", ".mov", ".wmv", ".mkv", ".webm", ".m4v",
    }

    def __init__(
        self,
        media_dir: str,
        temp_dir: str,
        sample_rate: int = 16000,
        timeout_s: int = 600,
    ):
        self.media_dir = str(Path(media_dir).resolve())
        self.temp_dir = str(Path(temp_dir).resolve())
        self.sample_rate = sample_rate
        self.timeout_s = timeout_s
        if not os.path.isdir(self.media_dir):
            raise FileValidationError(f"Media directory does not exist: {self.media_dir}")

    @classmethod
    def from_config(cls, config: PipelineConfig) -> "MediaHandler":
        from .parallel.mesh import rank_dir

        return cls(
            media_dir=config.media_dir,
            temp_dir=rank_dir(config.temp_dir),  # each rank's own under a mesh
            sample_rate=config.audio.sample_rate,
            timeout_s=config.subprocess_timeout_s,
        )

    # -- discovery -------------------------------------------------------------

    def validate_file(self, file_path: str) -> bool:
        all_ext = self.AUDIO_EXTENSIONS | self.VIDEO_EXTENSIONS
        return validate_file(
            file_path,
            must_exist=True,
            allowed_extensions=list(all_ext),
            min_size_bytes=100,
        )

    def _prepare_temp_dir(self) -> None:
        if os.path.exists(self.temp_dir):
            shutil.rmtree(self.temp_dir)
        os.makedirs(self.temp_dir, exist_ok=True)

    def find_media_file(self) -> Tuple[str, bool]:
        """First audio file (sorted), else first video file."""
        self._prepare_temp_dir()
        for extensions, is_video in (
            (self.AUDIO_EXTENSIONS, False),
            (self.VIDEO_EXTENSIONS, True),
        ):
            for fname in sorted(os.listdir(self.media_dir)):
                full = os.path.join(self.media_dir, fname)
                if not os.path.isfile(full):
                    continue
                if Path(fname).suffix.lower() in extensions:
                    logger.info(
                        "Found %s file: %s", "video" if is_video else "audio", fname
                    )
                    return full, is_video
        raise MediaNotFoundError(
            f"No valid media file found in {self.media_dir}",
            details=(
                f"Supported audio: {self.AUDIO_EXTENSIONS}\n"
                f"Supported video: {self.VIDEO_EXTENSIONS}"
            ),
        )

    def find_specific_file(self, filename: str) -> Tuple[str, bool]:
        full = os.path.join(self.media_dir, filename)
        if not os.path.isfile(full):
            # absolute/relative paths outside media_dir also accepted
            if os.path.isfile(filename):
                full = os.path.abspath(filename)
            else:
                raise MediaNotFoundError(f"File not found: {filename}")
        ext = Path(full).suffix.lower()
        if ext in self.AUDIO_EXTENSIONS:
            return full, False
        if ext in self.VIDEO_EXTENSIONS:
            return full, True
        raise MediaNotFoundError(
            f"Unsupported file format: {ext}", details=f"File: {filename}"
        )

    # -- conversion -------------------------------------------------------------

    @staticmethod
    def _check_ffmpeg() -> bool:
        try:
            return (
                subprocess.run(
                    ["ffmpeg", "-version"], capture_output=True, timeout=10
                ).returncode
                == 0
            )
        except (subprocess.SubprocessError, FileNotFoundError):
            return False

    @retry_with_backoff(
        config=RetryConfig(max_attempts=2, initial_delay_s=1.0),
        exceptions=(subprocess.SubprocessError,),
    )
    def convert_to_wav(self, input_path: str) -> str:
        """Convert media to mono 16-bit WAV at the configured rate."""
        self.validate_file(input_path)
        os.makedirs(self.temp_dir, exist_ok=True)
        base = Path(input_path).stem
        out_path = os.path.join(self.temp_dir, f"{base}_{self.sample_rate}Hz.wav")

        suffix = Path(input_path).suffix.lower()
        if suffix == ".wav":
            samples, sr = read_wav(input_path)  # folds to mono
            samples = resample_poly(samples, sr, self.sample_rate)
            write_wav(out_path, samples, self.sample_rate)
            logger.info("Converted to: %s (native decode)", out_path)
            return out_path

        native_error = None
        if suffix == ".flac":
            from .runtime.native_lib import native_flac_decode

            try:
                decoded = native_flac_decode(Path(input_path).read_bytes())
            except ValueError as exc:
                # Streams the strict native decoder rejects (trailing ID3v1
                # tags, post-frame padding, frame CRC damage) may still be
                # decodable by the libav shim / FFmpeg fallbacks below.
                logger.warning("Native FLAC decode failed: %s", exc)
                native_error = f"Invalid FLAC file: {exc}"
                decoded = None
            if decoded is not None:
                samples, sr = decoded
                samples = samples.mean(axis=1)  # fold to mono
                samples = resample_poly(samples, sr, self.sample_rate)
                write_wav(out_path, samples, self.sample_rate)
                logger.info("Converted to: %s (native FLAC decode)", out_path)
                return out_path
            # toolchain missing / stream rejected: fall through

        if suffix == ".mp3":
            from .runtime.native_lib import native_mp3_decode

            try:
                decoded = native_mp3_decode(Path(input_path).read_bytes())
            except ValueError as exc:
                # MPEG-2/2.5 low-sample-rate files and intensity-stereo
                # streams are out of the native decoder's scope; the libav
                # shim / FFmpeg fallbacks below still handle them.
                logger.warning("Native MP3 decode failed: %s", exc)
                native_error = f"Cannot decode MP3 file: {exc}"
                decoded = None
            if decoded is not None:
                samples, sr = decoded
                samples = samples.mean(axis=1)  # fold to mono
                samples = resample_poly(samples, sr, self.sample_rate)
                write_wav(out_path, samples, self.sample_rate)
                logger.info("Converted to: %s (native MP3 decode)", out_path)
                return out_path
            # toolchain missing / stream rejected: fall through

        # Every other container (OGG/M4A/MP4/Opus/WebM/...), and any stream
        # the first-party decoders rejected, decodes in-process against the
        # system libav shared libraries (runtime/native/av/av_shim.cc).
        from .runtime.native_lib import native_av_decode

        try:
            decoded = native_av_decode(input_path)
        except ValueError as exc:
            logger.warning("libav shim decode failed: %s", exc)
            if native_error is None:
                native_error = f"libav decode failed: {exc}"
            decoded = None
        if decoded is not None:
            samples, sr = decoded
            samples = samples.mean(axis=1)  # fold to mono
            samples = resample_poly(samples, sr, self.sample_rate)
            write_wav(out_path, samples, self.sample_rate)
            logger.info("Converted to: %s (libav in-process decode)", out_path)
            return out_path

        if not self._check_ffmpeg():
            raise MediaConversionError(
                native_error or "Cannot decode non-WAV media",
                details=(
                    f"{input_path}: first-party decoders cover WAV/FLAC/MP3, "
                    "the libav shim covers other containers when system "
                    "libavformat/libavcodec are present, and no FFmpeg binary "
                    "is on PATH as a last resort."
                ),
            )

        cmd = [
            "ffmpeg", "-y", "-i", input_path, "-vn",
            "-acodec", "pcm_s16le", "-ac", "1", "-ar", str(self.sample_rate),
            out_path,
        ]
        logger.info("Converting %s to WAV...", Path(input_path).name)
        try:
            result = subprocess.run(cmd, capture_output=True, timeout=self.timeout_s)
        except subprocess.TimeoutExpired:
            raise MediaConversionError(
                f"FFmpeg timed out after {self.timeout_s}s",
                details="Consider increasing timeout or checking the input file",
            )
        if result.returncode != 0:
            stderr = result.stderr.decode(errors="replace")
            raise MediaConversionError("FFmpeg conversion failed", details=stderr[-1000:])
        if not os.path.exists(out_path) or os.path.getsize(out_path) < 100:
            raise MediaConversionError("Output file missing or too small")
        logger.info("Converted to: %s", out_path)
        return out_path

    # -- metadata ----------------------------------------------------------------

    def get_media_info(self, input_path: str) -> dict:
        """Duration / rate / channels / codec; native for WAV, ffprobe otherwise."""
        if Path(input_path).suffix.lower() == ".wav":
            try:
                info = wav_info(input_path)
                return {
                    "duration": info.get("duration", 0.0),
                    "sample_rate": info.get("sample_rate", 0),
                    "channels": info.get("channels", 0),
                    "codec": info.get("codec", "pcm"),
                    "bit_rate": int(
                        info.get("sample_rate", 0)
                        * info.get("channels", 0)
                        * info.get("bit_depth", 0)
                    ),
                }
            except Exception as exc:
                logger.warning("Failed to get media info: %s", exc)
                return {}
        from .runtime.native_lib import native_av_probe

        info = native_av_probe(input_path)
        if info is not None:
            return info
        try:
            result = subprocess.run(
                [
                    "ffprobe", "-v", "quiet", "-print_format", "json",
                    "-show_format", "-show_streams", input_path,
                ],
                capture_output=True,
                timeout=30,
            )
            if result.returncode == 0:
                info = json.loads(result.stdout.decode())
                audio = next(
                    (s for s in info.get("streams", []) if s.get("codec_type") == "audio"),
                    {},
                )
                return {
                    "duration": float(info.get("format", {}).get("duration", 0)),
                    "sample_rate": int(audio.get("sample_rate", 0)),
                    "channels": int(audio.get("channels", 0)),
                    "codec": audio.get("codec_name", "unknown"),
                    "bit_rate": int(info.get("format", {}).get("bit_rate", 0)),
                }
        except Exception as exc:
            logger.warning("Failed to get media info: %s", exc)
        return {}

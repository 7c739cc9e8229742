"""The port's native runtime and media handler held against the JAX
package's on the CPU.

The port builds its own copy of the C++ sources (``runtime/native/``)
into ``modular_audio_pipeline_tpu_torch/_build/`` under a file lock. Its
FLAC and MP3 decodes equal the JAX package's library's to the bit, on the
fixtures of tests/test_flac.py and tests/test_mp3.py (MP3 only where those
tests find libmp3lame and libmpg123, skipped as they skip); its DTW
backtrace equals the port's Python one; four processes building at once
all load one library. ``MediaHandler`` discovers, validates and converts
as the JAX package's does: converted WAVs are equal byte for byte.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from flac_ref import encode_flac
from test_flac import make_pcm
from test_mp3 import lame_encode, needs_codecs, speechy, tone, transient

from modular_audio_pipeline_tpu import audio_io as jio
from modular_audio_pipeline_tpu.config import PipelineConfig as JaxConfig
from modular_audio_pipeline_tpu.exceptions import MediaNotFoundError as JaxNotFound
from modular_audio_pipeline_tpu.media_handler import MediaHandler as JaxMediaHandler
from modular_audio_pipeline_tpu.runtime import native_lib as jax_native
from modular_audio_pipeline_tpu_torch import audio_io as pio
from modular_audio_pipeline_tpu_torch.config import PipelineConfig
from modular_audio_pipeline_tpu_torch.exceptions import (
    FileValidationError,
    MediaConversionError,
    MediaNotFoundError,
)
from modular_audio_pipeline_tpu_torch.media_handler import MediaHandler
from modular_audio_pipeline_tpu_torch.models.whisper.timestamps import dtw_path_python
from modular_audio_pipeline_tpu_torch.runtime import native_lib

ROOT = Path(__file__).resolve().parents[1]
SR = 16000

pytestmark = pytest.mark.skipif(not jax_native.have_native(),
                                reason="native toolchain unavailable")


def test_the_ports_library_is_its_own_build():
    assert native_lib.have_native()
    assert Path(native_lib._lib._name).parent == ROOT / "modular_audio_pipeline_tpu_torch/_build"
    assert Path(native_lib._lib._name).name.startswith("libmap_audio-")


@pytest.mark.parametrize("case", [
    dict(channels=1), dict(channels=2), dict(channels=1, smooth=False),
    dict(channels=1, subframe="lpc8"), dict(channels=2, subframe="fixed2", stereo="mid_side"),
    dict(channels=1, subframe="verbatim", blocksize=1000),
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_flac_decode_equals_jax(case):
    kw = {k: v for k, v in case.items() if k not in ("channels", "smooth")}
    pcm = make_pcm(n=21000, channels=case["channels"], smooth=case.get("smooth", True))
    blob = encode_flac(pcm, SR, **kw)
    got, got_sr = native_lib.native_flac_decode(blob)
    want, want_sr = jax_native.native_flac_decode(blob)
    assert got_sr == want_sr == SR
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("blob", [b"\x00not flac" * 50, "crc", "truncated"])
def test_flac_errors_equal_jax(blob):
    good = encode_flac(make_pcm(n=9000), SR)
    if blob == "crc":
        blob = good[:-3] + bytes([good[-3] ^ 0xFF]) + good[-2:]
    elif blob == "truncated":
        blob = good[: len(good) - 40]
    with pytest.raises(ValueError) as got:
        native_lib.native_flac_decode(blob)
    with pytest.raises(ValueError) as want:
        jax_native.native_flac_decode(blob)
    assert str(got.value) == str(want.value)


@needs_codecs
@pytest.mark.parametrize("name", ["mono", "short_blocks", "vbr", "joint_stereo", "stereo"])
def test_mp3_decode_equals_jax(name):
    sr = 44100
    mp3 = {
        "mono": lambda: lame_encode(speechy(sr), sr, kbps=128),
        "short_blocks": lambda: lame_encode(transient(sr), sr, kbps=128),
        "vbr": lambda: lame_encode(speechy(sr), sr, vbr=True),
        "joint_stereo": lambda: lame_encode(np.stack([speechy(sr, seed=1), tone(sr, 1.5)], 1), sr),
        "stereo": lambda: lame_encode(np.stack([speechy(sr, seed=2), tone(sr, 1.5)], 1), sr,
                                      kbps=256, joint_stereo=False),
    }[name]()
    (got, got_sr), (want, want_sr) = native_lib.native_mp3_decode(mp3), jax_native.native_mp3_decode(mp3)
    assert got_sr == want_sr == sr
    np.testing.assert_array_equal(got, want)


def test_dtw_and_pcm_helpers():
    rng = np.random.default_rng(0)
    for s_len, t_len in ((1, 7), (12, 40), (30, 30), (57, 203)):
        cost = rng.standard_normal((s_len, t_len))
        np.testing.assert_array_equal(native_lib.native_dtw_path(cost), dtw_path_python(cost))
    x = rng.uniform(-1.2, 1.2, 5000).astype(np.float32)
    np.testing.assert_array_equal(native_lib.native_f32_to_pcm16(x), jax_native.native_f32_to_pcm16(x))
    pcm = rng.integers(-32768, 32767, 5000).astype(np.int16)
    np.testing.assert_array_equal(native_lib.native_pcm16_to_f32(pcm), jax_native.native_pcm16_to_f32(pcm))


def test_four_processes_building_at_once_all_load(tmp_path):
    """A fresh build directory and four processes started together: the
    lock lets one compile, the others wait and load its library; no
    temporary file is left behind."""
    code = (
        "import sys; from pathlib import Path\n"
        "from modular_audio_pipeline_tpu_torch.runtime import native_lib as n\n"
        f"n._BUILD_DIR = Path({str(tmp_path)!r})\n"
        "lib = n.load_native()\n"
        "from modular_audio_pipeline_tpu_torch.models.whisper.timestamps import dtw_path_python\n"
        "import numpy as np\n"
        "cost = np.random.default_rng(1).standard_normal((9, 20))\n"
        "print(lib is not None and (n.native_dtw_path(cost) == dtw_path_python(cost)).all())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [o.strip() for o, _ in outs] == ["True"] * 4, outs
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".so") == [
        native_lib._library_path("libmap_audio", sorted(native_lib._SRC_DIR.glob("*.cc")),
                                 native_lib._FLAGS).name]
    assert not list(tmp_path.glob("*.tmp"))


def handlers(media, temp):
    return (MediaHandler(str(media), str(temp / "pt")), JaxMediaHandler(str(media), str(temp / "jax")))


def test_discovery_and_errors_equal_jax(tmp_path):
    media = tmp_path / "media"
    media.mkdir()
    ours, theirs = handlers(media, tmp_path)
    for h, err in ((ours, MediaNotFoundError), (theirs, JaxNotFound)):
        with pytest.raises(err, match="No valid media file"):
            h.find_media_file()
    (media / "b.mp4").write_bytes(b"\x00" * 200)
    assert ours.find_media_file() == theirs.find_media_file() == (str(media / "b.mp4"), True)
    jio.write_wav(str(media / "z.wav"), np.zeros(800, np.float32), SR)
    (media / "a.flac").write_bytes(encode_flac(make_pcm(n=4000), SR))
    (media / "notes.txt").write_text("not media")
    assert ours.find_media_file() == theirs.find_media_file() == (str(media / "a.flac"), False)
    assert ours.find_specific_file("z.wav") == theirs.find_specific_file("z.wav")
    for name in ("nope.wav", "notes.txt"):
        with pytest.raises(MediaNotFoundError) as got:
            ours.find_specific_file(name)
        with pytest.raises(JaxNotFound) as want:
            theirs.find_specific_file(name)
        assert str(got.value) == str(want.value)
    (media / "tiny.wav").write_bytes(b"RIFF")
    with pytest.raises(FileValidationError, match="below the 100 B minimum"):
        ours.validate_file(str(media / "tiny.wav"))
    with pytest.raises(MediaConversionError):
        ours.convert_to_wav(str(media / "b.mp4"))
    with pytest.raises(FileValidationError, match="does not exist"):
        MediaHandler(str(tmp_path / "missing"), str(tmp_path / "t"))
    assert ours.get_media_info(str(media / "z.wav")) == theirs.get_media_info(str(media / "z.wav"))
    assert pio.wav_info(str(media / "z.wav")) == jio.wav_info(str(media / "z.wav"))


def test_conversions_equal_jax(tmp_path):
    """A 44.1 kHz stereo WAV (mono fold + resample), a FLAC and an MP3
    (where libmp3lame is found) convert to equal 16 kHz WAVs."""
    import wave

    media = tmp_path / "media"
    media.mkdir()
    st = (np.stack([speechy(44100, 2.0), 0.8 * speechy(44100, 2.0, seed=4)], 1) * 32767)
    with wave.open(str(media / "st.wav"), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(44100)
        wf.writeframes(st.astype("<i2").tobytes())
    (media / "rec.flac").write_bytes(encode_flac(make_pcm(n=32000, channels=2), SR, subframe="lpc4"))
    names = ["st.wav", "rec.flac"]
    import test_mp3

    if test_mp3._LAME is not None:
        (media / "rec.mp3").write_bytes(lame_encode(speechy(44100), 44100))
        names.append("rec.mp3")
    ours, theirs = handlers(media, tmp_path)
    for name in names:
        got, want = ours.convert_to_wav(str(media / name)), theirs.convert_to_wav(str(media / name))
        assert Path(got).name == Path(want).name
        assert Path(got).read_bytes() == Path(want).read_bytes(), name
    cfg = PipelineConfig(media_dir=str(media))
    assert MediaHandler.from_config(cfg).temp_dir == JaxMediaHandler.from_config(
        JaxConfig(media_dir=str(media))).temp_dir
    assert json.dumps(sorted(MediaHandler.AUDIO_EXTENSIONS)) == json.dumps(
        sorted(JaxMediaHandler.AUDIO_EXTENSIONS))


@pytest.mark.skipif(not jax_native.have_native_av(),
                    reason="libav shim unavailable (no system libav)")
@pytest.mark.parametrize("ext,codec", [(".ogg", "libvorbis"), (".m4a", "aac")])
def test_libav_shim_decodes_and_converts_equal_jax(tmp_path, ext, codec):
    """Where the system libav libraries are installed, the port's copy of
    the shim decodes, probes and converts a container as the JAX
    package's does (fixtures encoded by the JAX package's shim; skipped
    where it has no such encoder, as tests/test_av_ingest.py skips)."""
    lib = jax_native.load_native_av()
    if not lib.av_shim_have_encoder(codec.encode()):
        pytest.skip(f"no {codec} encoder in this libav")
    media = tmp_path / "media"
    media.mkdir()
    path = media / f"rec{ext}"
    assert jax_native.native_av_encode(str(path), speechy(SR, 2.0), SR, codec)
    (got, got_sr), (want, want_sr) = (native_lib.native_av_decode(str(path)),
                                      jax_native.native_av_decode(str(path)))
    assert got_sr == want_sr
    np.testing.assert_array_equal(got, want)
    assert native_lib.native_av_probe(str(path)) == jax_native.native_av_probe(str(path))
    ours, theirs = handlers(media, tmp_path)
    got, want = ours.convert_to_wav(str(path)), theirs.convert_to_wav(str(path))
    assert Path(got).read_bytes() == Path(want).read_bytes()

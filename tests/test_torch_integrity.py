"""The port's integrity layer (``runtime/integrity.py``) against the JAX
package's, on the CPU.

Counterpart of ``tests/test_integrity.py``, case for case: host and device
checksums agree, a zeroed buffer never validates, a corrupted fetch or
upload raises, the decode's pending dict carries the checksums (beam and
greedy) and ``finalize_decode`` fetches through them. ``host_checksum`` is
held bit-equal to the JAX function, and ``checksum_device`` equal to the
JAX device checksum on 1-, 2- and 4-byte dtypes. Then one test for each
defect of the JAX module that the port does not copy (ADVICE.md): an
unverified checksum fetch, 8-byte dtypes, an empty list, and a verified
copy that is not the one the model uses.
"""

import logging

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_model import one_torch_thread  # noqa: F401  (autouse)

from modular_audio_pipeline_tpu.runtime import integrity as jax_integrity
from modular_audio_pipeline_tpu_torch.exceptions import FetchIntegrityError
from modular_audio_pipeline_tpu_torch.runtime import integrity
from modular_audio_pipeline_tpu_torch.runtime.integrity import (
    checksum_device,
    fetch_verified_many,
    host_checksum,
    put_verified,
    put_verified_tree,
)

# odd sizes: a 1- or 2-byte buffer that is not a whole number of words
SIZES = (0, 1, 3, 7, 33, 1001)
NUMPY_DTYPES = (np.int8, np.uint8, np.int16, np.int32, np.int64, np.float16, np.float32,
                np.float64, np.bool_)


def _array(dtype, n: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 1000).astype(dtype)


class TestChecksum:
    def test_host_device_agree_int32(self):
        x = np.arange(-50, 950, dtype=np.int32).reshape(10, 100)
        chk = checksum_device((torch.from_numpy(x),)).numpy()
        assert chk[0] == host_checksum(x)

    def test_host_device_agree_float32(self):
        x = np.random.default_rng(0).standard_normal((7, 33)).astype(np.float32)
        chk = checksum_device((torch.from_numpy(x),)).numpy()
        assert chk[0] == host_checksum(x)

    def test_zeroed_buffer_never_validates(self):
        # The salt guarantees a zeroed data buffer + zeroed checksum fetch
        # still mismatch: host_checksum(zeros) == salt ^ 0 != 0.
        zeros = np.zeros((4, 4), np.int32)
        assert host_checksum(zeros) != np.uint32(0)

    def test_multiple_arrays_one_call(self):
        a = np.arange(12, dtype=np.int32)
        b = np.linspace(-1, 1, 9, dtype=np.float32)
        chk = checksum_device((torch.from_numpy(a), torch.from_numpy(b))).numpy()
        assert chk.shape == (2,) and chk.dtype == np.int64
        assert chk[0] == host_checksum(a)
        assert chk[1] == host_checksum(b)

    @pytest.mark.parametrize("dtype", NUMPY_DTYPES, ids=lambda d: np.dtype(d).name)
    def test_host_checksum_is_the_jax_function_bit_for_bit(self, dtype):
        for n in SIZES:
            x = _array(dtype, n, seed=n)
            got, want = host_checksum(x), jax_integrity.host_checksum(x)
            assert got.dtype == want.dtype == np.uint32 and got == want, (n, got, want)
            assert checksum_device([torch.from_numpy(x)]).numpy()[0] == got

    @pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "float16", "bfloat16",
                                       "int32", "float32"])
    def test_device_checksum_equals_the_jax_device_checksum(self, dtype):
        """1-, 2- and 4-byte dtypes (the JAX function's packing)."""
        for n in SIZES:
            x = np.random.default_rng(n).standard_normal(n) * 100
            if dtype == "bfloat16":
                host = x.astype(ml_dtypes.bfloat16)
                t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
            elif dtype == "int8":
                # non-negative: the JAX device path widens int8 with its sign
                # (below), where its host checksum reads bytes
                host = np.clip(np.abs(x), 0, 127).astype(np.int8)
                t = torch.from_numpy(host)
            else:
                host = x.astype(dtype)
                t = torch.from_numpy(host)
            want = np.asarray(jax_integrity.checksum_device((jnp.asarray(host),)))[0]
            assert checksum_device([t]).numpy()[0] == int(want), (dtype, n)

    def test_negative_int8_is_checksummed_as_bytes(self):
        """The JAX device checksum widens a negative int8 with its sign, so
        it disagrees with the JAX host checksum of the same buffer; the
        port's device checksum reads bytes, as both host functions do."""
        x = np.array([-1, 2, -3, 4, -128], np.int8)
        port = checksum_device([torch.from_numpy(x)]).numpy()[0]
        jax_device = int(np.asarray(jax_integrity.checksum_device((jnp.asarray(x),)))[0])
        assert port == host_checksum(x) == jax_integrity.host_checksum(x)
        assert jax_device != port


class TestFetchVerified:
    def test_good_fetch_passes(self):
        a = torch.arange(100, dtype=torch.int32)
        b = torch.ones((3, 3))
        chk = checksum_device((a, b))
        hosts = fetch_verified_many((a, b), chk, ("a", "b"))
        np.testing.assert_array_equal(hosts[0], np.arange(100, dtype=np.int32))
        np.testing.assert_array_equal(hosts[1], np.ones((3, 3), np.float32))

    def test_corrupted_fetch_raises(self):
        a = torch.arange(100, dtype=torch.int32)
        # checksum computed from DIFFERENT device data = persistent
        # corruption (re-fetches return the same wrong bytes)
        wrong = checksum_device((torch.zeros(100, dtype=torch.int32),))
        with pytest.raises(FetchIntegrityError):
            fetch_verified_many((a,), wrong, ("a",), retries=2)

    def test_decode_pending_carries_checksum(self):
        """_decode_pending attaches the device checksums of the buffers
        finalize_decode fetches (beam and greedy), in the JAX order, and
        finalize_decode fetches through them; the tokens equal the JAX
        decode's on the same parameters."""
        from modular_audio_pipeline_tpu.models.whisper.config import WHISPER_DIMS
        from modular_audio_pipeline_tpu.models.whisper.decode import (
            DecodeOptions as JaxOptions,
            decode_windows_async,
            finalize_decode as jax_finalize,
        )
        from modular_audio_pipeline_tpu.models.whisper.model import init_params
        from modular_audio_pipeline_tpu.models.whisper.tokenizer import DummyTokenizer
        from modular_audio_pipeline_tpu_torch.models.whisper.convert import params_from_numpy
        from modular_audio_pipeline_tpu_torch.models.whisper.decode import (
            DecodeOptions,
            _decode_pending,
            finalize_decode,
        )
        from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import load_tokenizer

        dims = WHISPER_DIMS["test-tiny"]
        jparams = init_params(dims, seed=0, dtype=jnp.float32)
        params = params_from_numpy({k: v for k, v in _np_tree(jparams).items()}, "cpu",
                                   torch.float32)
        tok = load_tokenizer(None, n_vocab=dims.n_vocab)
        mel = np.random.default_rng(0).standard_normal((1, dims.n_mels, 3000)).astype(np.float32)
        for beam in (1, 2):
            kw = dict(language="en", beam_size=beam, max_tokens=8, timestamps=True)
            pending = _decode_pending(params, dims, tok, torch.from_numpy(mel),
                                      DecodeOptions(**kw))
            names = (("tokens", "sum_lp", "fin_tok", "fin_lp", "ns_prob") if beam > 1
                     else ("tokens", "sum_lp", "ns_prob"))
            assert pending.get("chk") is not None
            want = [host_checksum(pending[n].numpy()) for n in names]
            np.testing.assert_array_equal(pending["chk"].numpy(), want)
            before = integrity.counts["fetch"]
            result = finalize_decode(pending)
            assert integrity.counts["fetch"] == before + 1
            assert result.tokens.shape[0] == 1
            ref = jax_finalize(decode_windows_async(jparams, dims, DummyTokenizer(dims.n_vocab),
                                                    jnp.asarray(mel), JaxOptions(**kw)))
            np.testing.assert_array_equal(result.tokens, ref.tokens)

    def test_corrupted_decode_fetch_raises(self):
        """A pending dict whose checksums disagree with its buffers (a link
        that damaged the tokens) is refused, not parsed."""
        from modular_audio_pipeline_tpu_torch.models.whisper.decode import finalize_decode

        tokens = torch.full((1, 4), 7, dtype=torch.int64)
        sum_lp = torch.zeros(1)
        ns = torch.zeros(1)
        pending = {"tokens": tokens, "sum_lp": sum_lp, "ns_prob": ns, "beam": False, "b": 1,
                   "eot": 7, "chk": checksum_device((torch.zeros_like(tokens), sum_lp, ns))}
        with pytest.raises(FetchIntegrityError, match="fetch"):
            finalize_decode(pending)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


class TestPutVerified:
    def test_good_upload_passes(self):
        a = np.arange(64, dtype=np.int32)
        b = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
        devs = put_verified([a, b], ["a", "b"], "cpu")
        np.testing.assert_array_equal(devs[0].numpy(), a)
        np.testing.assert_array_equal(devs[1].numpy(), b)

    def test_tree_upload_roundtrips(self):
        tree = {"w": np.ones((4, 4), np.float32), "nested": {"b": np.arange(3, dtype=np.int32)}}
        dev = put_verified_tree(tree, "cpu", name="t")
        np.testing.assert_array_equal(dev["w"].numpy(), tree["w"])
        np.testing.assert_array_equal(dev["nested"]["b"].numpy(), tree["nested"]["b"])

    def test_corrupted_upload_raises(self, monkeypatch):
        # Simulate a link that zeroes every upload: the device checksum is
        # computed from zeros, never matching the host's.
        real = integrity.checksum_device
        monkeypatch.setattr(integrity, "checksum_device",
                            lambda arrays: real([torch.zeros_like(a) for a in arrays]))
        with pytest.raises(FetchIntegrityError, match="upload") as err:
            put_verified([np.arange(16, dtype=np.int32)], ["a"], "cpu", retries=1)
        assert "what failed: the upload" in err.value.details

    def test_bfloat16_leaves_verify(self):
        a = torch.randn((33, 5), generator=torch.Generator().manual_seed(2)).bfloat16()
        (dev,) = put_verified([a], ["w"], "cpu")
        assert dev.dtype == torch.bfloat16
        assert torch.equal(dev.view(torch.int16), a.view(torch.int16))


class _FlakyChecksum:
    """A device checksum whose host fetches go wrong: the first ``bad``
    fetches return zeros (``steady``) or a different garbage each time."""

    def __init__(self, real: torch.Tensor, bad: int, steady: bool = True):
        self.real, self.bad, self.steady, self.n = real, bad, steady, 0

    def cpu(self):
        self.n += 1
        if self.n <= self.bad:
            fill = 0 if self.steady else self.n
            return torch.full_like(self.real, fill)
        return self.real.cpu()


class TestDefectsNotCopied:
    def test_damaged_checksum_fetch_is_fetched_again_not_reuploaded(self, monkeypatch, caplog):
        """(a) The checksum fetch itself is verified: a damaged one is
        fetched again before anything is uploaded again."""
        real = integrity.checksum_device
        monkeypatch.setattr(integrity, "checksum_device",
                            lambda arrays: _FlakyChecksum(real(arrays), bad=1))
        a = np.arange(16, dtype=np.int32)
        with caplog.at_level(logging.WARNING, logger=integrity.__name__):
            (dev,) = put_verified([a], ["a"], "cpu", retries=1)
        np.testing.assert_array_equal(dev.numpy(), a)
        assert "checksum fetch was damaged" in caplog.text
        assert "re-uploading" not in caplog.text

    def test_error_says_the_checksum_fetch_failed(self, monkeypatch):
        """(a) A checksum fetch that never returns the same value twice is
        reported as such, not as a failed upload."""
        real = integrity.checksum_device
        monkeypatch.setattr(integrity, "checksum_device",
                            lambda arrays: _FlakyChecksum(real(arrays), bad=100, steady=False))
        with pytest.raises(FetchIntegrityError) as err:
            put_verified([np.arange(16, dtype=np.int32)], ["a"], "cpu", retries=1)
        assert "what failed: the checksum fetch" in err.value.details

    @pytest.mark.parametrize("dtype", [np.int64, np.float64], ids=["int64", "float64"])
    def test_eight_byte_leaves_keep_their_type_and_verify(self, dtype):
        """(b) 8-byte dtypes: the device copy keeps the host dtype and its
        checksum covers two little-endian words per element."""
        a = _array(dtype, 1001)
        (dev,) = put_verified([a], ["x"], "cpu")
        assert dev.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(dev.numpy(), a)
        words = a.view(np.uint32)  # little-endian: low word first
        want = (int(words.astype(np.uint64).sum()) & 0xFFFFFFFF) ^ 0x9E3779B9
        assert checksum_device([dev]).numpy()[0] == want == host_checksum(a)

    def test_empty_list_and_tree(self):
        """(c) Nothing to upload returns nothing (the JAX module stacks an
        empty list and raises)."""
        assert put_verified([], [], "cpu") == []
        assert put_verified_tree({}, "cpu") == {}
        assert checksum_device([]).shape == (0,)
        with pytest.raises(ValueError):
            jax_integrity.put_verified([], [])

    def test_the_model_holds_the_verified_copy(self, monkeypatch):
        """(d) A bundle's leaves are cast on the host before the verified
        upload (and sliced for the rank under a mesh:
        ``test_torch_parallel.py``), and the model holds exactly the tensors
        that were verified: nothing re-places them afterwards. The load is
        taken on the CUDA branch with the upload kept on the CPU."""
        from modular_audio_pipeline_tpu_torch import transcriber

        seen = {}

        def spy(tree, device, name="params", retries=3):
            seen["dtypes"] = {str(v.dtype) for _, v in integrity._leaves(tree)}
            out = put_verified_tree(tree, "cpu", name, retries)
            seen["ids"] = [id(v) for _, v in integrity._leaves(out)]
            return out

        monkeypatch.setattr(transcriber, "put_verified_tree", spy)
        backend = transcriber.TorchWhisperBackend(
            "tiny", device="cpu",
            weights_path=str(transcriber.SHIPPED_WEIGHTS / "whisper-tiny-synth-proxy"))
        backend.device = torch.device("cuda")  # the branch a card takes
        backend.load()
        assert seen["dtypes"] == {"torch.bfloat16"}
        assert [id(v) for _, v in integrity._leaves(backend.params)] == seen["ids"]

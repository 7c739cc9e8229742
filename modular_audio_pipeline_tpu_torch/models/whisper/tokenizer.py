"""Whisper tokenizer: GPT-2 byte-level BPE + Whisper special tokens.

Self-contained replacement for the tokenizer assets the reference pulls in
through ``openai-whisper``/``faster-whisper``. The BPE tables
(``vocab.json``/``merges.txt``) are loaded from a converted checkpoint
directory; when none is available (offline test/bench runs) a
:class:`DummyTokenizer` maps UTF-8 bytes directly onto the first 256 vocab
ids so every decoding path stays exercisable end-to-end.

Special-token layout matches OpenAI Whisper exactly, including the
large-v3 shift (one extra language, vocab 51866).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["WhisperTokenizer", "DummyTokenizer", "load_tokenizer", "LANGUAGES"]

# Canonical whisper language order (multilingual token block). large-v3
# appends "yue" as the 100th entry.
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class _SpecialTokens:
    """Derived special-token ids for a given base-vocab size."""

    def __init__(self, n_base: int, n_languages: int):
        self.eot = n_base  # <|endoftext|>
        self.sot = n_base + 1  # <|startoftranscript|>
        self.language_start = n_base + 2
        self.n_languages = n_languages
        after_langs = self.language_start + n_languages
        self.translate = after_langs
        self.transcribe = after_langs + 1
        self.sot_lm = after_langs + 2  # <|startoflm|>
        self.sot_prev = after_langs + 3  # <|startofprev|>
        self.no_speech = after_langs + 4  # <|nospeech|>
        self.no_timestamps = after_langs + 5  # <|notimestamps|>
        self.timestamp_begin = after_langs + 6  # <|0.00|>


class WhisperTokenizer:
    """Byte-level BPE with Whisper's special-token arithmetic."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        n_vocab: int = 51865,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.n_vocab = n_vocab
        n_base = len(self.encoder)
        n_languages = 100 if n_vocab >= 51866 else 99
        self.special = _SpecialTokens(n_base, n_languages)
        self._cache: Dict[str, List[str]] = {}

    # -- special-token helpers -------------------------------------------

    @property
    def eot(self) -> int:
        return self.special.eot

    @property
    def sot(self) -> int:
        return self.special.sot

    @property
    def sot_prev(self) -> int:
        return self.special.sot_prev

    @property
    def no_speech(self) -> int:
        return self.special.no_speech

    @property
    def no_timestamps(self) -> int:
        return self.special.no_timestamps

    @property
    def timestamp_begin(self) -> int:
        return self.special.timestamp_begin

    def language_token(self, language: str) -> int:
        lang = language.lower()
        if lang not in LANGUAGES[: self.special.n_languages]:
            raise KeyError(f"Unknown language: {language}")
        return self.special.language_start + LANGUAGES.index(lang)

    def task_token(self, task: str) -> int:
        return self.special.transcribe if task == "transcribe" else self.special.translate

    def sot_sequence(
        self, language: str = "en", task: str = "transcribe", timestamps: bool = True
    ) -> List[int]:
        seq = [self.sot, self.language_token(language), self.task_token(task)]
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    def timestamp_to_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    def is_timestamp(self, token: int) -> bool:
        return token >= self.timestamp_begin

    def non_speech_tokens(self) -> List[int]:
        """Symbol/music tokens whisper suppresses during decoding."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + [
            " -", " '", " ♪", "♪",
        ]
        out = []
        for s in symbols:
            ids = self.encode(s)
            if len(ids) == 1:
                out.append(ids[0])
        return sorted(set(out))

    # -- BPE --------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        if not word:
            return []
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        # GPT-2's exact split pattern (letters and numbers are separate
        # classes, fixed contraction list) so prompt/prefix token ids match
        # openai-whisper byte-for-byte.
        import regex

        pat = regex.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
            r"|\s+(?!\S)|\s+"
        )
        ids: List[int] = []
        for piece in pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                tid = self.encoder.get(sub)
                if tid is not None:
                    ids.append(tid)
                else:  # unknown merge result: emit per-char ids
                    ids.extend(
                        self.encoder.get(ch, 0) for ch in sub
                    )
        return ids

    def decode(self, tokens: Sequence[int]) -> str:
        parts = []
        for t in tokens:
            t = int(t)
            if t >= len(self.decoder):  # special token -> skipped in text
                continue
            parts.append(self.decoder[t])
        text = "".join(parts)
        raw = bytearray(self.byte_decoder.get(ch, ord("?")) for ch in text)
        return raw.decode("utf-8", errors="replace")

    def decode_with_timestamps(self, tokens: Sequence[int]) -> str:
        out = []
        for t in tokens:
            t = int(t)
            if t >= self.timestamp_begin:
                out.append(f"<|{self.timestamp_to_seconds(t):.2f}|>")
            else:
                out.append(self.decode([t]))
        return "".join(out)


class DummyTokenizer(WhisperTokenizer):
    """Byte-identity tokenizer for offline tests/benches (no BPE tables).

    Text bytes map to ids 0..255; the special-token block sits at the same
    offsets as the real multilingual tokenizer so decode-loop logic
    (timestamps, language/task tokens, suppression) is identical.
    """

    def __init__(self, n_vocab: int = 51865):
        # Special block: eot + sot + languages (99 or 100) + 6 task/control
        # tokens + 1501 timestamps => base vocab is 50257 for both layouts.
        n_languages = 100 if n_vocab >= 51866 else 99
        n_base = n_vocab - (2 + n_languages + 6 + 1501)
        vocab = {chr(i): i for i in range(256)}
        super().__init__(vocab, merges=[], n_vocab=n_vocab)
        # Recompute specials with the real base size (50257 / 50258).
        self.special = _SpecialTokens(n_base, 100 if n_vocab >= 51866 else 99)

    def encode(self, text: str) -> List[int]:
        return [b for b in text.encode("utf-8")]

    def decode(self, tokens: Sequence[int]) -> str:
        """Bytes decode as bytes; other base-vocab ids become synthetic
        words so random-weight runs still produce non-empty text."""
        parts: List[str] = []
        byte_buf = bytearray()
        n_base = self.special.eot
        for t in tokens:
            t = int(t)
            if t < 256:
                byte_buf.append(t)
                continue
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf = bytearray()
            if t < n_base:
                parts.append(f" w{t}")
        if byte_buf:
            parts.append(byte_buf.decode("utf-8", errors="replace"))
        return "".join(parts)

    def non_speech_tokens(self) -> List[int]:
        return [ord(c) for c in '"#()*+/:;<=>@[\\]^_`{|}~']


def load_tokenizer(weights_dir: Optional[str], n_vocab: int = 51865) -> WhisperTokenizer:
    """Load BPE tables from a converted checkpoint dir, or fall back to
    the byte-level dummy tokenizer when absent.

    A real checkpoint dir without BPE assets would decode every transcript
    into garbage (OpenAI .pt checkpoints ship no vocab.json/merges.txt),
    so that case warns loudly instead of degrading silently.
    """
    import logging

    if weights_dir:
        d = Path(weights_dir)
        vocab_path = d / "vocab.json"
        merges_path = d / "merges.txt"
        if vocab_path.exists() and merges_path.exists():
            vocab = json.loads(vocab_path.read_text(encoding="utf-8"))
            merges = []
            for line in merges_path.read_text(encoding="utf-8").splitlines():
                if line.startswith("#") or not line.strip():
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
            return WhisperTokenizer(vocab, merges, n_vocab=n_vocab)
        if (d / "byte_tokenizer.json").exists():
            # Checkpoint trained WITH the byte-identity tokenizer (the
            # zero-egress synthetic-ASR proxy) — it is the right one.
            return DummyTokenizer(n_vocab=n_vocab)
        if d.is_dir():
            logging.getLogger(__name__).warning(
                "Checkpoint dir %s has no vocab.json/merges.txt — falling "
                "back to the byte-identity DummyTokenizer. Real-weight "
                "transcripts WILL be garbage; export the BPE tables during "
                "conversion (convert.py writes them when the source "
                "checkpoint provides a tokenizer).",
                weights_dir,
            )
    return DummyTokenizer(n_vocab=n_vocab)

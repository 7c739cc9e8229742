"""serve.whisper_s (s): the Whisper stage of one request, from its first
``log_mel`` to the end of its last ``_attach_words_batch``, the card
waited for at both ends; the median over the window's requests. Layer:
transcriber.TorchWhisperBackend window path. Moves audio_x."""

import statistics


def read(ctx):
    xs = ctx.get("spans", {}).get("whisper")
    return statistics.median(xs) if xs else None

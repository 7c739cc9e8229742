"""decode.step_ms (ms): the decode span (``_decode_pending`` through
``finalize_decode``, the card waited for at both ends) summed over the
window's requests, over the decode steps the harness counted in them.
Layer: models/whisper/decode. Moves audio_x."""


def read(ctx):
    spans = ctx.get("spans", {}).get("decode")
    steps = sum(w["decode_steps"] for w in ctx.get("work", []))
    if not spans or not steps:
        return None
    return sum(spans) / steps * 1e3

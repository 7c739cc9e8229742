"""serve.diarization_s (s): ``_diarize_windows`` of one request (the
segmentation and embedding networks over the kept timeline, then the
host's clustering), the card waited for at its end; the median over the
window's requests. Layer: diarizer.SpeakerDiarizer. Moves audio_x."""

import statistics


def read(ctx):
    xs = ctx.get("spans", {}).get("diarization")
    return statistics.median(xs) if xs else None

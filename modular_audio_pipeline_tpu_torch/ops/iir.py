"""IIR (biquad) filtering as a parallel scan of affine maps (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/iir.py``. The order-2
recurrence ``y[n] = f[n] - a1 y[n-1] - a2 y[n-2]`` (``f`` the FIR part of
the b taps) is the affine map ``s[n] = M s[n-1] + (f[n], 0)`` on the state
``s = (y[n], y[n-1])``, with ``M = [[-a1, -a2], [1, 0]]``. Maps compose
associatively, so every prefix comes from a log-depth doubling scan
(Hillis-Steele: log2(C) rounds of elementwise 2x2 products) inside chunks
of ``C`` samples, and the state crosses chunk boundaries sequentially.
The sums are associated differently from a serial filter's, so outputs
agree with ``scipy.signal.lfilter`` (and the JAX package) to float
precision, not to the bit. The pipeline does not call it: loudness
K-weighting filters in the frequency domain (``ops.loudness.k_weight``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["biquad_filter", "sosfilt"]

_CHUNK = 1 << 16  # samples per parallel block


def _fir_part(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2], zero initial conditions."""
    x1 = torch.nn.functional.pad(x, (1, 0))[..., :-1]
    x2 = torch.nn.functional.pad(x, (2, 0))[..., :-2]
    return b[0] * x + b[1] * x1 + b[2] * x2


def _prefix_maps(m, c0: torch.Tensor):
    """Inclusive prefix compositions along dim 0 of the affine maps
    ``s -> M s + (c0[i], 0)``, each applied after the ones before it: the
    prefix of ``i`` as its 2x2 matrix entries and offset, one tensor each
    (the matrices' products written out: a batched 2x2 ``@`` is slow)."""
    n = c0.shape[0]
    ones = torch.ones_like(c0)
    p = [m[0][0] * ones, m[0][1] * ones, m[1][0] * ones, m[1][1] * ones]
    q = [c0, torch.zeros_like(c0)]
    d = 1
    while d < n:
        r00, r01, r10, r11 = (t[d:] for t in p)  # the later map
        l00, l01, l10, l11 = (t[:-d] for t in p)  # the prefix before it
        lq0, lq1 = q[0][:-d], q[1][:-d]
        new_p = [r00 * l00 + r01 * l10, r00 * l01 + r01 * l11,
                 r10 * l00 + r11 * l10, r10 * l01 + r11 * l11]
        new_q = [r00 * lq0 + r01 * lq1 + q[0][d:], r10 * lq0 + r11 * lq1 + q[1][d:]]
        for t, new in zip(p + q, new_p + new_q):
            t[d:] = new
        d *= 2
    return p, q


def biquad_filter(x: torch.Tensor, b, a) -> torch.Tensor:
    """One normalised biquad (a0 == 1) along the last axis of ``x``, as
    ``scipy.signal.lfilter(b, a, x)`` with zero initial state."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    f = _fir_part(x, torch.as_tensor(b, dtype=x.dtype, device=x.device))
    m = ((-float(a[1]), -float(a[2])), (1.0, 0.0))
    y1 = x.new_zeros(x.shape[:-1])  # the state (y[n-1], y[n-2]) across chunks
    y2 = x.new_zeros(x.shape[:-1])
    out = []
    for start in range(0, x.shape[-1], _CHUNK):
        fc = f[..., start : start + _CHUNK].movedim(-1, 0)  # [C, ...]
        (p00, p01, _, _), (q0, _) = _prefix_maps(m, fc)
        y = p00 * y1 + p01 * y2 + q0  # each prefix applied to the incoming state
        y2 = y[-2] if y.shape[0] > 1 else y1
        y1 = y[-1]
        out.append(y.movedim(0, -1))
    return torch.cat(out, dim=-1)


def sosfilt(x: torch.Tensor, sos: np.ndarray) -> torch.Tensor:
    """Cascade of second-order sections, each row ``(b0, b1, b2, a0, a1, a2)``."""
    y = x
    for row in np.asarray(sos, np.float64):
        y = biquad_filter(y, row[:3] / row[3], row[3:] / row[3])
    return y

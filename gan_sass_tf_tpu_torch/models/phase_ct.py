"""Phase-decomposed transposed convolution: `g_phase_ct`.

Port of `gan_sass_tf_tpu/models/phase_ct.py`.  A flax
`ConvTranspose(cout, (kt, kf), strides=(st, sf), "SAME")` computes, per
axis, y[s·t + p] = Σ_d x[t + d] · W[s·d − p + pad_a].  Grouping the taps
by output phase p gives ONE stride-1 convolution whose kernel holds each
phase's taps in st·sf·cout output channels (absent taps zero), then a
depth-to-space interleave.  Its backward has stride-1 convolutions only.

The parameter is the port's ConvTranspose one ((cin, cout, kt, kf), the
flax kernel flipped, as `models/convert.py` lays it out), so checkpoints
and optimizer state are those of `nn.ConvTranspose2d`; the phase kernel is
assembled from it on every call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _same_pad_a(k: int, s: int) -> int:
    """Left padding lax.conv_transpose applies to the dilated input for
    padding='SAME' (output length = input length * stride)."""
    pad_len = k + s - 2
    if s > k - 1:
        return k - 1
    return int(math.ceil(pad_len / 2))


def _phase_plan(k: int, s: int):
    """Per-dim tap plan: for each phase p and kernel tap k_idx, the input
    offset d with k_idx = s*d - p + pad_a.  Returns (d_min, n_taps,
    [(p, j, k_idx)]) with j = d - d_min the assembled-kernel position."""
    pad_a = _same_pad_a(k, s)
    entries = []
    d_lo, d_hi = None, None
    for p in range(s):
        d_min_p = math.ceil((p - pad_a) / s)
        d_max_p = math.floor((k - 1 + p - pad_a) / s)
        for d in range(d_min_p, d_max_p + 1):
            k_idx = s * d - p + pad_a
            assert 0 <= k_idx < k
            entries.append((p, d, k_idx))
            d_lo = d if d_lo is None else min(d_lo, d)
            d_hi = d if d_hi is None else max(d_hi, d)
    n_taps = d_hi - d_lo + 1
    return d_lo, n_taps, [(p, d - d_lo, k_idx) for p, d, k_idx in entries]


def _tap_index(kt: int, kf: int, st: int, sf: int):
    """(st, sf, jt, jf) int64: the flat (kt_i·kf + kf_i) flax tap that fills
    each position of the phase kernel, kt·kf where none does; and the
    (low, high) padding per axis of the stride-1 conv."""
    dt_lo, jt, t_plan = _phase_plan(kt, st)
    df_lo, jf, f_plan = _phase_plan(kf, sf)
    idx = torch.full((st, sf, jt, jf), kt * kf, dtype=torch.int64)
    for pt, jt_i, kt_i in t_plan:
        for pf, jf_i, kf_i in f_plan:
            idx[pt, pf, jt_i, jf_i] = kt_i * kf + kf_i
    return idx, ((-dt_lo, jt - 1 + dt_lo), (-df_lo, jf - 1 + df_lo))


def phase_conv_transpose(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         strides, dtype: torch.dtype) -> torch.Tensor:
    """x (B, cin, T, F) -> (B, cout, T·st, F·sf): flax's "SAME"
    ConvTranspose, from the port's ConvTranspose2d weight (cin, cout, kt,
    kf) and bias, computed in `dtype`."""
    cin, cout, kt, kf = weight.shape
    st, sf = strides
    idx, ((pt0, pt1), (pf0, pf1)) = _tap_index(kt, kf, st, sf)
    taps = weight.flip(2, 3).permute(2, 3, 1, 0).reshape(kt * kf, cout, cin)
    taps = torch.cat([taps, taps.new_zeros(1, cout, cin)])
    big = taps[idx.to(weight.device)]                    # (st, sf, jt, jf, cout, cin)
    big = big.permute(0, 1, 4, 5, 2, 3).reshape(st * sf * cout, cin, *idx.shape[2:])
    y = F.conv2d(F.pad(x.to(dtype), (pf0, pf1, pt0, pt1)), big.to(dtype))
    b, _, t, f = y.shape
    y = y.reshape(b, st, sf, cout, t, f).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, cout, t * st, f * sf) + bias.to(dtype)[:, None, None]

"""Conv U-Net generator: mixture features (B, T, F_feat) -> per-source masks
over the linear STFT bins, (B, S, T, K) magnitude or (B, S, T, K, 2) complex.

Port of `gan_sass_tf_tpu/models/generator.py` (`ConvUNetGenerator` with
the stride-(1,1) stem and `dec_l0="conv"`, `MaskHead` on its linear-grid
1x1 and `interp` paths).  Activations are NCHW inside; the public layout is
the JAX package's.  Flax semantics kept exactly:

  * "SAME" padding of a strided conv is asymmetric (even axis: (0, 1));
    convs pad explicitly with `_same_pad` instead of `padding=1`.
  * `nn.ConvTranspose` "SAME" = zero-insertion, pad (k-1-p) per the lax
    rule, cross-correlation with the unflipped kernel; here
    `conv_transpose2d` with a pre-flipped kernel (models/convert.py) and
    the per-axis padding of `_ct_padding`, then a crop to the skip.
  * `compute_dtype` casts activations and weights for every conv and the
    mel warp; params stay f32 and masks leave in f32.
  * `crop_nyquist` (`g_crop_nyquist`) drops the Nyquist bin of linear-grid
    features before the net and repeats the last mask column after it.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan_sass_tf_tpu_torch.dsp.features import mel_interp_matrix
from gan_sass_tf_tpu_torch.dsp.masks import mask_channels


def _standardize(x: torch.Tensor, dims, eps: float = 1e-5) -> torch.Tensor:
    """Per-example standardization (population variance, as jnp.var)."""
    mu = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def _mask_exit(out: torch.Tensor, mask_type: str, mask_activation: str,
               num_sources: int) -> torch.Tensor:
    """(B, S[+slot], T, K, mc) logits -> masks, in f32 whatever the compute
    dtype."""
    out = out.float()
    if mask_type == "complex":
        return torch.tanh(out)                              # (B,S,T,K,2)
    out = out[..., 0]                                       # (B,S,T,K)
    if mask_activation == "softmax":
        return torch.softmax(out, dim=1)[:, :num_sources]   # drop noise slot
    return torch.sigmoid(out)


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax "SAME" padding (low, high) of one axis for a strided conv."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _ct_padding(k: int, s: int) -> int:
    """conv_transpose2d padding reproducing lax.conv_transpose "SAME"
    (its low pad is k-1 when s > k-1, else ceil((k+s-2)/2))."""
    pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
    return k - 1 - pad_a


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
          stride: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    kh, kw = conv.kernel_size
    pt = _same_pad(x.shape[2], kh, stride[0])
    pf = _same_pad(x.shape[3], kw, stride[1])
    x = F.pad(x.to(dtype), (pf[0], pf[1], pt[0], pt[1]))
    return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride)


class MaskHead(nn.Module):
    """Hidden grid (B, C, T, F_feat) -> masks.  Linear-grid features take a
    1x1 conv; mel-grid features take the `interp` head: the 1x1 conv at the
    mel grid first, then the fixed mel->bin warp."""

    def __init__(self, in_channels: int, num_sources: int, n_bins: int,
                 feature_dim: int, mask_type: str, mask_activation: str,
                 noise_slot: bool, sample_rate: float):
        super().__init__()
        self.num_sources, self.mask_type = num_sources, mask_type
        self.mask_activation = mask_activation
        slots = num_sources + int(noise_slot and mask_activation == "softmax"
                                  and mask_type == "magnitude")
        self.slots, self.mc = slots, mask_channels(mask_type)
        self.conv = nn.Conv2d(in_channels, slots * self.mc, 1)
        if feature_dim != n_bins:     # interp (the registry admits no other)
            warp = mel_interp_matrix(feature_dim, n_bins, sample_rate)
            self.register_buffer("warp", torch.from_numpy(warp), persistent=False)
        else:
            self.warp = None

    def forward(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = _conv(self.conv, h, dtype)                    # (B, O, T, F_feat)
        if self.warp is not None:
            out = out @ self.warp.to(dtype).T               # (B, O, T, K)
        b, _, t, k = out.shape
        out = out.reshape(b, self.slots, self.mc, t, k).permute(0, 1, 3, 4, 2)
        return _mask_exit(out, self.mask_type, self.mask_activation,
                          self.num_sources)


class ConvUNetGenerator(nn.Module):
    """Frequency- (and optionally time-) strided conv U-Net.

    Parameters mirror the flax tree: `convs[i]` is Conv_i, `deconvs[i]` is
    ConvTranspose_i, `head.conv` is MaskHead_0/Conv_0."""

    def __init__(self, num_sources: int, n_bins: int, feature_dim: int,
                 mask_type: str, mask_activation: str,
                 noise_slot: bool = False,
                 channels: Sequence[int] = (32, 64, 128), leak: float = 0.2,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 time_stride: bool = True, decoder_slim: float = 1.0,
                 sample_rate: float = 0.0, crop_nyquist: bool = False):
        super().__init__()
        self.leak, self.dropout, self.dtype = leak, dropout, dtype
        self.n_bins = n_bins
        # g_crop_nyquist: run the net on the even K-1 bin grid and copy the
        # top bin's mask from its neighbour (linear-grid features, odd K).
        self.crop = crop_nyquist and feature_dim == n_bins and n_bins % 2 == 1
        self.down = (2, 2) if time_stride else (1, 2)
        convs, deconvs = [], []
        cin = 1
        for c in channels:                      # encoder: 2 convs per level
            convs += [nn.Conv2d(cin, c, 3), nn.Conv2d(c, c, 3)]
            cin = c
        convs.append(nn.Conv2d(cin, channels[-1], 3))       # bottleneck
        cin = channels[-1]
        for c in reversed(channels):            # decoder
            cd = max(8, int(c * decoder_slim))
            deconvs.append(nn.ConvTranspose2d(cin, cd, 3, stride=self.down))
            convs.append(nn.Conv2d(cd + c, cd, 3))
            cin = cd
        self.convs = nn.ModuleList(convs)
        self.deconvs = nn.ModuleList(deconvs)
        self.n_levels = len(channels)
        self.head = MaskHead(cin, num_sources, n_bins, feature_dim, mask_type,
                             mask_activation, noise_slot, sample_rate)

    def forward(self, feats: torch.Tensor, train: bool = False) -> torch.Tensor:
        """feats (B, T, F_feat) -> masks (B, S, T, K[, 2]) f32."""
        if train and self.dropout > 0:
            raise NotImplementedError(
                "dropout at train time is not ported yet (ROADMAP.md, "
                "'Modules to port', item 9: remaining model options)")
        act = lambda v: F.leaky_relu(v, self.leak)
        dt, L = self.dtype, self.n_levels
        crop = self.crop and feats.shape[2] == self.n_bins
        if crop:
            feats = feats[:, :, :-1]
        x = _standardize(feats.float(), dims=(1, 2))[:, None].to(dt)
        skips = []
        for lvl in range(L):
            x = act(_conv(self.convs[2 * lvl], x, dt))
            skips.append(x)
            x = act(_conv(self.convs[2 * lvl + 1], x, dt, self.down))
        x = act(_conv(self.convs[2 * L], x, dt))
        for lvl, skip in enumerate(reversed(skips)):
            ct = self.deconvs[lvl]
            pad = tuple(_ct_padding(3, s) for s in self.down)
            x = F.conv_transpose2d(x.to(dt), ct.weight.to(dt), ct.bias.to(dt),
                                   self.down, pad)
            x = act(x[:, :, : skip.shape[2], : skip.shape[3]])
            x = torch.cat([x, skip], dim=1)
            x = act(_conv(self.convs[2 * L + 1 + lvl], x, dt))
        masks = self.head(x, dt)
        if crop:           # Nyquist-bin mask := its neighbour's (axis 3 = bins)
            masks = torch.cat([masks, masks[:, :, :, -1:]], dim=3)
        return masks


def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in place, flax's defaults: lecun-normal kernels
    (std 1/sqrt(fan_in)), zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                cin = m.in_channels
                fan_in = cin * math.prod(m.kernel_size)
                nn.init.normal_(m.weight, 0.0, fan_in ** -0.5, generator=generator)
                nn.init.zeros_(m.bias)
    return module

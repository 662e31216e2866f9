"""Mask generators: mixture features (B, T, F_feat) -> per-source masks
over the linear STFT bins, (B, S, T, K) magnitude or (B, S, T, K, 2) complex.

Port of `gan_sass_tf_tpu/models/generator.py`: `ConvUNetGenerator` with
every stem (none, strided conv, fold), decoder (`dec_l0` conv or
subpixel, ConvTranspose or `PhaseConvTranspose`) and head (1x1, interp,
dense, packed film, fold, the subpixel restore); `BiLSTMGenerator` with
the sequence trunk's heads; `ToyMLPGenerator`.  All share `MaskHead`, one
class as in flax.  Activations are NCHW inside; the public layout is the
JAX package's.  Flax semantics kept exactly:

  * "SAME" padding of a strided conv is asymmetric (even axis: (0, 1)),
    and a dilated kernel pads its dilated extent; convs pad explicitly
    with `_same_pad` instead of `padding=1`.
  * `nn.ConvTranspose` "SAME" = zero-insertion, pad (k-1-p) per the lax
    rule, cross-correlation with the unflipped kernel; here
    `conv_transpose2d` with a pre-flipped kernel (models/convert.py) and
    the per-axis padding of `_ct_padding`, then a crop to the skip.
  * space-to-depth and depth-to-space order channels (pt, pf, C) as
    flax's reshapes do: channel (pt·sf + pf)·C + c.  `F.pixel_shuffle`
    orders them (C, pt, pf) and takes square factors only, so it is not
    used.
  * the packed film head resizes a conv trunk's grid to its cells with
    `jax.image.resize(..., "nearest")`, half-pixel centres: torch's
    "nearest-exact", not "nearest".
  * `compute_dtype` casts activations and weights for every conv, dense,
    LSTM and the mel warp; params stay f32 and masks leave in f32.
  * `crop_nyquist` (`g_crop_nyquist`) drops the Nyquist bin of linear-grid
    features before the net and repeats the last mask column after it.
  * flax's `OptimizedLSTMCell` has one bias per gate (on the recurrent
    kernel); `nn.LSTM` has two.  The BiLSTM holds flax's parameters only,
    gates packed (i, f, g, o) as `torch.lstm` takes them, and passes a
    zero input bias, so the optimizer, the clip and the EMA see what the
    reference's see.
  * dropout (`ModelConfig.dropout`) runs at train time only, where flax's
    `nn.Dropout` sits, with masks from a `DropoutKey` (models/dropout.py).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan_sass_tf_tpu_torch.dsp.features import mel_interp_matrix
from gan_sass_tf_tpu_torch.dsp.masks import mask_channels
from gan_sass_tf_tpu_torch.models.dropout import NCHW, DropoutKey, dropout_fn
from gan_sass_tf_tpu_torch.models.phase_ct import phase_conv_transpose


def _standardize(x: torch.Tensor, dims, eps: float = 1e-5) -> torch.Tensor:
    """Per-example standardization (population variance, as jnp.var)."""
    mu = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def _slots(num_sources: int, noise_slot: bool, mask_type: str,
           mask_activation: str) -> int:
    """Mask slots: the sources, plus the noise slot of softmax magnitude
    masks (dropped after the softmax)."""
    return num_sources + int(noise_slot and mask_activation == "softmax"
                             and mask_type == "magnitude")


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
          stride: Tuple[int, int] = (1, 1),
          dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """A flax "SAME" conv: a dilated kernel pads its dilated extent."""
    (kh, kw), (dh, dw) = conv.kernel_size, dilation
    pt = _same_pad(x.shape[2], (kh - 1) * dh + 1, stride[0])
    pf = _same_pad(x.shape[3], (kw - 1) * dw + 1, stride[1])
    x = F.pad(x.to(dtype), (pf[0], pf[1], pt[0], pt[1]))
    return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride,
                    dilation=dilation)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _space_to_depth(x: torch.Tensor, st: int, sf: int) -> torch.Tensor:
    """(B, C, T, F) -> (B, st·sf·C, ceil(T/st), ceil(F/sf)), zero-padded to
    multiples of the strides; channel (pt·sf + pf)·C + c, as flax's
    reshape of each (st, sf) cell."""
    x = F.pad(x, (0, -x.shape[3] % sf, 0, -x.shape[2] % st))
    b, c, t, f = x.shape
    x = x.reshape(b, c, t // st, st, f // sf, sf).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, st * sf * c, t // st, f // sf)


def _depth_to_space(x: torch.Tensor, st: int, sf: int) -> torch.Tensor:
    """Inverse of `_space_to_depth` (no crop): (B, st·sf·C, T, F) ->
    (B, C, T·st, F·sf)."""
    b, n, t, f = x.shape
    x = x.reshape(b, st, sf, n // (st * sf), t, f).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, n // (st * sf), t * st, f * sf)


def _position_encoding(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(n, 5): [k_pos, sin(2π·k_pos·q) for q in 1, 2, 4, 8], k_pos =
    linspace(0, 1, n), built in `dtype` as jnp builds it: 2π is rounded
    to `dtype` before the product (in bf16 a Python-float 2π would move
    the sines by up to 0.18)."""
    k_pos = torch.linspace(0.0, 1.0, n, device=device).to(dtype)
    # A fill, not a copy from the host: a captured step can hold it.
    two_pi = torch.full((), 2.0 * math.pi, dtype=dtype, device=device)
    return torch.stack([k_pos] + [torch.sin(two_pi * k_pos * q)
                                  for q in (1.0, 2.0, 4.0, 8.0)], dim=-1)


def _film(x: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """leaky_relu(x·(1+γ)+β, 0.2): x (B, C, T, W), gb = [γ, β] along dim 1,
    (B, 2C, T, W) or (B, 2C, T, 1) broadcast over W."""
    gamma, beta = gb.chunk(2, dim=1)
    return F.leaky_relu(x * (1.0 + gamma) + beta, 0.2)


class MaskHead(nn.Module):
    """Hidden features -> masks: flax's `MaskHead`, every branch.  A conv
    trunk hands it (B, C, T, W) (`conv_trunk`), a sequence trunk (B, T, D).
    `convs[i]` is MaskHead_0/Conv_i and `denses[i]` MaskHead_0/Dense_i.

      * conv: a conv trunk on the linear grid: a 1x1 conv.
      * interp: a conv trunk on the mel grid: the 1x1 conv at the mel grid
        first, then the fixed mel->bin warp.
      * dense: Dense(S·K·mc) on h; a conv trunk's grid is flattened to
        (B, T, W·C), C minor, as flax reshapes its NHWC tensor.
      * film (sequence trunks): bin-local (1, 5) convs with bin dilations
        1, 2, 4 over the standardized input spectrogram and a fixed
        position encoding, each FiLM-modulated by Dense(2c)(h) broadcast
        over bins; a 1x1 conv.
      * pack ("filmpack", and "film" on a conv trunk): the same on the
        lane-packed relayout (B, T, K/f, f) of the input (K padded to a
        multiple of f) with (3, 3) convs; h enters through 1x1 convs, on
        h broadcast over the cells (sequence trunk) or on the trunk's grid
        nearest-resized to (T, cells) (conv trunk); the f·S·mc output
        channels unfold back to K bins.
    """

    def __init__(self, in_features: int, num_sources: int, n_bins: int,
                 mask_type: str, mask_activation: str, noise_slot: bool,
                 head_mode: str, conv_trunk: bool, grid: int = 0,
                 sample_rate: float = 0.0, film_channels: int = 64,
                 film_fold: int = 8):
        """`grid`: the width W of a conv trunk's grid at the head (the
        feature grid); `in_features`: its channels, or a sequence trunk's
        D."""
        super().__init__()
        self.num_sources, self.n_bins = num_sources, n_bins
        self.mask_type, self.mask_activation = mask_type, mask_activation
        self.slots = _slots(num_sources, noise_slot, mask_type, mask_activation)
        self.mc = mask_channels(mask_type)
        c, f, out = film_channels, film_fold, self.slots * self.mc
        self.fold = f
        if (head_mode == "film" and conv_trunk) or head_mode == "filmpack":
            self.mode = "pack"
        elif head_mode == "film":
            self.mode = "film"
        elif conv_trunk and grid == n_bins:
            self.mode = "conv"
        elif conv_trunk and head_mode == "interp":
            self.mode = "interp"
        else:
            self.mode = "dense"
        convs, denses = [], []
        if self.mode in ("conv", "interp"):
            convs = [nn.Conv2d(in_features, out, 1)]
        elif self.mode == "dense":
            width = in_features * grid if conv_trunk else in_features
            denses = [nn.Linear(width, out * n_bins)]
        elif self.mode == "film":
            for i in range(3):
                convs.append(nn.Conv2d(6 if i == 0 else c, c, (1, 5)))
                denses.append(nn.Linear(in_features, 2 * c))
            convs.append(nn.Conv2d(c, out, 1))
        else:
            for i in range(3):
                convs += [nn.Conv2d(f + 5 if i == 0 else c, c, 3),
                          nn.Conv2d(in_features, 2 * c, 1)]
            convs.append(nn.Conv2d(c, f * out, 1))
        self.convs, self.denses = nn.ModuleList(convs), nn.ModuleList(denses)
        if self.mode == "interp":
            warp = mel_interp_matrix(grid, n_bins, sample_rate)
            self.register_buffer("warp", torch.from_numpy(warp), persistent=False)

    def forward(self, h: torch.Tensor, x_ref: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
        """h (B, C, T, W) or (B, T, D); x_ref (B, T, K) the standardized
        linear-grid input (film heads) -> masks (B, S, T, K[, 2]) f32."""
        k, s, mc = self.n_bins, self.slots, self.mc
        if self.mode in ("conv", "interp"):
            out = _conv(self.convs[0], h, dtype)            # (B, O, T, W)
            if self.mode == "interp":
                out = out @ self.warp.to(dtype).T           # (B, O, T, K)
            b, _, t, _ = out.shape
            out = out.reshape(b, s, mc, t, k).permute(0, 1, 3, 4, 2)
        elif self.mode == "dense":
            if h.dim() == 4:                                # (B, T, W·C), C minor
                h = h.permute(0, 2, 3, 1).flatten(2)
            b, t = h.shape[:2]
            out = _dense(self.denses[0], h, dtype).reshape(b, t, s, k, mc)
            out = out.transpose(1, 2)                       # (B, S, T, K, mc)
        elif self.mode == "film":
            b, t = h.shape[:2]
            x = x_ref.to(dtype)[:, None]                    # (B, 1, T, K)
            enc = _position_encoding(k, dtype, x.device).T  # (5, K)
            x = torch.cat([x, enc[None, :, None].expand(b, -1, t, -1)], dim=1)
            for i, dil in enumerate((1, 2, 4)):
                x = _conv(self.convs[i], x, dtype, dilation=(1, dil))
                gb = _dense(self.denses[i], h, dtype)       # (B, T, 2c)
                x = _film(x, gb.transpose(1, 2)[..., None])
            out = _conv(self.convs[3], x, dtype)            # (B, S·mc, T, K)
            out = out.reshape(b, s, mc, t, k).permute(0, 1, 3, 4, 2)
        else:                                               # pack
            f = self.fold
            b, t = x_ref.shape[:2]
            kp = -(-k // f) * f
            cells = kp // f
            x = F.pad(x_ref, (0, kp - k)).reshape(b, t, cells, f).to(dtype)
            enc = _position_encoding(cells, dtype, x.device)
            x = torch.cat([x, enc.expand(b, t, -1, -1)], dim=-1)
            x = x.permute(0, 3, 1, 2)                       # (B, f+5, T, cells)
            if h.dim() == 4:   # the trunk's grid at the cells, as jax resizes
                ctx = F.interpolate(h.to(dtype), size=(t, cells), mode="nearest-exact")
            for i, dil in enumerate((1, 2, 4)):
                x = _conv(self.convs[2 * i], x, dtype, dilation=(1, dil))
                cc = self.convs[2 * i + 1]
                if h.dim() == 4:
                    gb = _conv(cc, ctx, dtype)              # (B, 2c, T, cells)
                else:                                       # 1x1 conv on h = dense
                    gb = F.linear(h.to(dtype), cc.weight[:, :, 0, 0].to(dtype),
                                  cc.bias.to(dtype)).transpose(1, 2)[..., None]
                x = _film(x, gb)
            out = _conv(self.convs[6], x, dtype)            # (B, f·S·mc, T, cells)
            out = out.reshape(b, f, s, mc, t, cells).permute(0, 2, 4, 5, 1, 3)
            out = out.reshape(b, s, t, kp, mc)[:, :, :, :k]
        return _mask_exit(out, self.mask_type, self.mask_activation,
                          self.num_sources)


class ConvUNetGenerator(nn.Module):
    """Frequency- (and optionally time-) strided conv U-Net.

    Parameters mirror the flax tree: `convs[i]` is Conv_i (the stem conv,
    the encoder, the bottleneck, the decoder, then the fold or restore
    head's 1x1 convs, in flax's call order), `deconvs[i]` ConvTranspose_i
    or, with `phase_ct`, `phase_deconvs[i]` PhaseConvTranspose_i, and
    `head` MaskHead_0 (absent with the fold head)."""

    def __init__(self, num_sources: int, n_bins: int, feature_dim: int,
                 mask_type: str, mask_activation: str,
                 noise_slot: bool = False,
                 channels: Sequence[int] = (32, 64, 128), leak: float = 0.2,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 time_stride: bool = True, stem_stride: Tuple[int, int] = (1, 1),
                 stem_mode: str = "conv", decoder_slim: float = 1.0,
                 head_mode: str = "dense", sample_rate: float = 0.0,
                 film_channels: int = 64, film_fold: int = 8,
                 dec_l0: str = "conv", phase_ct: bool = False,
                 crop_nyquist: bool = False):
        super().__init__()
        self.leak, self.dropout, self.dtype = leak, dropout, dtype
        self.num_sources, self.n_bins = num_sources, n_bins
        self.mask_type, self.mask_activation = mask_type, mask_activation
        # g_crop_nyquist: run the net on the even K-1 bin grid and copy the
        # top bin's mask from its neighbour (linear-grid features, odd K).
        self.crop = crop_nyquist and feature_dim == n_bins and n_bins % 2 == 1
        k_bins = n_bins - 1 if self.crop else n_bins
        self.down = (2, 2) if time_stride else (1, 2)
        self.stem, self.stem_mode = tuple(stem_stride), stem_mode
        st, sf = self.stem
        strided = self.stem != (1, 1)
        self.fold_head = strided and head_mode == "fold"
        self.restore = strided and head_mode not in ("fold", "film")
        self.dec_l0, self.phase_ct = dec_l0, phase_ct
        self.n_levels = len(channels)
        convs, ups = [], []
        cin = 1
        if strided and stem_mode == "conv":                 # kernel = 2x stride
            convs.append(nn.Conv2d(1, channels[0], (2 * st, 2 * sf)))
            cin = channels[0]
        elif strided:                                       # fold
            cin = st * sf
        self.n_stem = len(convs)
        for c in channels:                      # encoder: 2 convs per level
            convs += [nn.Conv2d(cin, c, 3), nn.Conv2d(c, c, 3)]
            cin = c
        convs.append(nn.Conv2d(cin, channels[-1], 3))       # bottleneck
        cin = channels[-1]
        for lvl, c in enumerate(reversed(channels)):        # decoder
            cd = max(8, int(c * decoder_slim))
            if dec_l0 == "subpixel" and lvl == len(channels) - 1:
                convs.append(nn.Conv2d(cin, cd * self.down[0] * self.down[1], 1))
                cin = cd + c
            else:
                ups.append(nn.ConvTranspose2d(cin, cd, 3, stride=self.down))
                convs.append(nn.Conv2d(cd + c, cd, 3))
                cin = cd
        c0 = min(channels[0], 32)       # full-grid width per bin of both heads
        if self.fold_head:
            slots = _slots(num_sources, noise_slot, mask_type, mask_activation)
            convs += [nn.Conv2d(cin + st * sf, c0 * st * sf, 1),
                      nn.Conv2d(c0 * st * sf,
                                st * sf * slots * mask_channels(mask_type), 1)]
        elif self.restore:
            convs.append(nn.Conv2d(cin, c0 * st * sf, 1))
            cin = c0 + 1                # the restored grid and the input skip
        self.convs = nn.ModuleList(convs)
        # Two names, as flax's ConvTranspose_i and PhaseConvTranspose_i.
        setattr(self, "phase_deconvs" if phase_ct else "deconvs", nn.ModuleList(ups))
        if not self.fold_head:
            self.head = MaskHead(cin, num_sources, k_bins, mask_type,
                                 mask_activation, noise_slot, head_mode,
                                 conv_trunk=True,
                                 grid=k_bins if feature_dim == n_bins else feature_dim,
                                 sample_rate=sample_rate,
                                 film_channels=film_channels, film_fold=film_fold)

    def _up(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.phase_ct:
            ct = self.phase_deconvs[lvl]
            return phase_conv_transpose(x, ct.weight, ct.bias, self.down, dt)
        ct = self.deconvs[lvl]
        pad = tuple(_ct_padding(3, s) for s in self.down)
        return F.conv_transpose2d(x.to(dt), ct.weight.to(dt), ct.bias.to(dt),
                                  self.down, pad)

    def forward(self, feats: torch.Tensor, train: bool = False,
                dropout: Optional[DropoutKey] = None) -> torch.Tensor:
        """feats (B, T, F_feat) -> masks (B, S, T, K[, 2]) f32.  Dropout
        sites: 0 after the bottleneck, 1 + l after decoder level l's 3x3
        conv."""
        act = lambda v: F.leaky_relu(v, self.leak)          # noqa: E731
        drop = dropout_fn(self.dropout, train, dropout)
        dt, L = self.dtype, self.n_levels
        crop = self.crop and feats.shape[2] == self.n_bins
        if crop:
            feats = feats[:, :, :-1]
        t_in, f_in = feats.shape[1], feats.shape[2]
        x = _standardize(feats.float(), dims=(1, 2))[:, None].to(dt)
        x_full = x                      # the full-resolution input skip
        st, sf = self.stem
        if self.n_stem:
            x = act(_conv(self.convs[0], x, dt, (st, sf)))
        elif self.stem != (1, 1):
            x = _space_to_depth(x, st, sf)
        ci = self.n_stem                # the next Conv_i
        skips = []
        for _ in range(L):
            x = act(_conv(self.convs[ci], x, dt))
            skips.append(x)
            x = act(_conv(self.convs[ci + 1], x, dt, self.down))
            ci += 2
        x = drop(act(_conv(self.convs[ci], x, dt)), 0, NCHW)
        ci += 1
        for lvl, skip in enumerate(reversed(skips)):
            crop_to = (slice(None), slice(None), slice(0, skip.shape[2]),
                       slice(0, skip.shape[3]))
            if self.dec_l0 == "subpixel" and lvl == L - 1:
                # 1x1 expansion at the half grid, depth-to-space; no 3x3
                # conv and no dropout at this level.
                x = _depth_to_space(_conv(self.convs[ci], x, dt), *self.down)
                x = torch.cat([act(x[crop_to]), skip], dim=1)
                ci += 1
                continue
            x = torch.cat([act(self._up(lvl, x)[crop_to]), skip], dim=1)
            x = drop(act(_conv(self.convs[ci], x, dt)), 1 + lvl, NCHW)
            ci += 1
        if self.fold_head:
            # Masks from the folded grid: the folded input skip, a 1x1 conv,
            # the mask conv, depth-to-space on the mask logits only.
            x = torch.cat([x, _space_to_depth(x_full, st, sf)], dim=1)
            out = _conv(self.convs[ci + 1], act(_conv(self.convs[ci], x, dt)), dt)
            out = _depth_to_space(out, st, sf)[:, :, :t_in, :f_in]
            b, _, t, k = out.shape
            out = out.reshape(b, -1, mask_channels(self.mask_type), t, k)
            masks = _mask_exit(out.permute(0, 1, 3, 4, 2), self.mask_type,
                               self.mask_activation, self.num_sources)
        else:
            if self.restore:            # subpixel restore of the full grid
                x = _depth_to_space(_conv(self.convs[ci], x, dt), st, sf)
                x = torch.cat([act(x[:, :, :t_in, :f_in]), x_full], dim=1)
            masks = self.head(x, x_full[:, 0], dt)
        if crop:           # Nyquist-bin mask := its neighbour's (axis 3 = bins)
            masks = torch.cat([masks, masks[:, :, :, -1:]], dim=3)
        return masks


class ToyMLPGenerator(nn.Module):
    """Per-frame MLP: standardize, then Dense / ReLU / dropout twice, then
    the dense `MaskHead`.  `denses[i]` is Dense_i, `head` MaskHead_0."""

    def __init__(self, num_sources: int, n_bins: int, feature_dim: int,
                 mask_type: str, mask_activation: str, noise_slot: bool = False,
                 hidden: int = 256, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.denses = nn.ModuleList([nn.Linear(feature_dim, hidden),
                                     nn.Linear(hidden, hidden)])
        self.head = MaskHead(hidden, num_sources, n_bins, mask_type,
                             mask_activation, noise_slot, "dense", conv_trunk=False)

    def forward(self, feats: torch.Tensor, train: bool = False,
                dropout: Optional[DropoutKey] = None) -> torch.Tensor:
        """feats (B, T, F_feat) -> masks (B, S, T, K[, 2]) f32.  Dropout
        site i after Dense_i."""
        drop = dropout_fn(self.dropout, train, dropout)
        h = _standardize(feats.float(), dims=(1, 2)).to(self.dtype)
        for i, layer in enumerate(self.denses):
            h = drop(torch.relu(_dense(layer, h, self.dtype)), i)
        return self.head(h, None, self.dtype)


class LSTMCellParams(nn.Module):
    """One direction of one layer: flax's OptimizedLSTMCell parameters with
    the gates packed (i, f, g, o) along the rows, as `torch.lstm` takes
    them.  `weight_ih` (4H, in) packs the ii/if/ig/io kernels (no bias),
    `weight_hh` (4H, H) the hi/hf/hg/ho kernels, `bias` (4H) their biases."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.empty(4 * hidden))


class BiLSTMGenerator(nn.Module):
    """Stacked bidirectional LSTM over frames, then a sequence mask head.

    `cells[2l]` is layer l forward (flax OptimizedLSTMCell_{2l}) and
    `cells[2l+1]` layer l backward; the backward direction reads the
    reversed sequence and writes in the original time order, and each
    layer's output is [forward, backward] along the features, as flax's
    `Bidirectional`.  The recurrence runs in `torch.lstm`, one call a
    layer (dropout follows each layer), in the compute dtype: weights and
    input cast to it, the gate matmuls accumulated in f32.  On the card
    cuDNN runs it in bf16 too (its elemWiseRNNcell kernels for
    __nv_bfloat16), though `torch.backends.cudnn.is_acceptable` answers
    False for a bf16 tensor.  In bf16 the carry differs from flax's, which
    promotes c and h to f32 between steps; here the hidden state between
    steps and layers is bf16."""

    def __init__(self, num_sources: int, n_bins: int, feature_dim: int,
                 mask_type: str, mask_activation: str, noise_slot: bool = False,
                 hidden: int = 300, layers: int = 2, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, head_mode: str = "dense",
                 film_channels: int = 64, film_fold: int = 8):
        super().__init__()
        self.hidden, self.layers, self.dropout, self.dtype = hidden, layers, dropout, dtype
        self.cells = nn.ModuleList(
            LSTMCellParams(feature_dim if l == 0 else 2 * hidden, hidden)
            for l in range(layers) for _ in range(2))
        self.head = MaskHead(2 * hidden, num_sources, n_bins, mask_type,
                             mask_activation, noise_slot, head_mode,
                             conv_trunk=False, film_channels=film_channels,
                             film_fold=film_fold)

    def forward(self, feats: torch.Tensor, train: bool = False,
                dropout: Optional[DropoutKey] = None) -> torch.Tensor:
        """feats (B, T, F_feat) -> masks (B, S, T, K[, 2]) f32.  Dropout
        site l after layer l."""
        drop = dropout_fn(self.dropout, train, dropout)
        dt = self.dtype
        x0 = _standardize(feats.float(), dims=(1, 2))      # (B, T, F)
        h = x0.to(dt)
        zeros = x0.new_zeros((2, x0.shape[0], self.hidden), dtype=dt)
        for layer in range(self.layers):
            weights = []
            for cell in self.cells[2 * layer: 2 * layer + 2]:
                # The input bias is zero: one bias a gate.
                weights += [cell.weight_ih.to(dt), cell.weight_hh.to(dt),
                            cell.bias.new_zeros(cell.bias.shape, dtype=dt),
                            cell.bias.to(dt)]
            with warnings.catch_warnings():
                # cuDNN copies the weights into one buffer each call and
                # warns; they are cast to the compute dtype each call anyway.
                warnings.filterwarnings("ignore", message="RNN module weights")
                # train=True keeps what the backward needs (cuDNN's reserve
                # space).
                h, _, _ = torch.lstm(h, (zeros, zeros), weights, True, 1, 0.0,
                                     torch.is_grad_enabled(), True, True)
            h = drop(h, layer)
        return self.head(h, x0, dt)


def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in place, flax's defaults: lecun-normal kernels
    (std 1/sqrt(fan_in)), orthogonal recurrent kernels (one H x H block a
    gate), zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = m.in_features if isinstance(m, nn.Linear) \
                    else m.in_channels * math.prod(m.kernel_size)
                nn.init.normal_(m.weight, 0.0, fan_in ** -0.5, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LSTMCellParams):
                nn.init.normal_(m.weight_ih, 0.0, m.weight_ih.shape[1] ** -0.5,
                                generator=generator)
                for block in m.weight_hh.split(m.hidden):
                    nn.init.orthogonal_(block, generator=generator)
                nn.init.zeros_(m.bias)
    return module

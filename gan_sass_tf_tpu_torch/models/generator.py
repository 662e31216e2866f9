"""Mask generators: mixture features (B, T, F_feat) -> per-source masks
over the linear STFT bins, (B, S, T, K) magnitude or (B, S, T, K, 2) complex.

Port of `gan_sass_tf_tpu/models/generator.py`: `ConvUNetGenerator` with
the stride-(1,1) stem and `dec_l0="conv"`, its `MaskHead` on the
linear-grid 1x1 and `interp` paths; `BiLSTMGenerator` with the sequence
trunk's `dense`, `film` and `filmpack` heads.  Activations are NCHW
inside; the public layout is the JAX package's.  Flax semantics kept
exactly:

  * "SAME" padding of a strided conv is asymmetric (even axis: (0, 1)),
    and a dilated kernel pads its dilated extent; convs pad explicitly
    with `_same_pad` instead of `padding=1`.
  * `nn.ConvTranspose` "SAME" = zero-insertion, pad (k-1-p) per the lax
    rule, cross-correlation with the unflipped kernel; here
    `conv_transpose2d` with a pre-flipped kernel (models/convert.py) and
    the per-axis padding of `_ct_padding`, then a crop to the skip.
  * `compute_dtype` casts activations and weights for every conv, dense,
    LSTM and the mel warp; params stay f32 and masks leave in f32.
  * `crop_nyquist` (`g_crop_nyquist`) drops the Nyquist bin of linear-grid
    features before the net and repeats the last mask column after it.
  * flax's `OptimizedLSTMCell` has one bias per gate (on the recurrent
    kernel); `nn.LSTM` has two.  The BiLSTM holds flax's parameters only,
    gates packed (i, f, g, o) as `torch.lstm` takes them, and passes a
    zero input bias, so the optimizer, the clip and the EMA see what the
    reference's see.
"""

from __future__ import annotations

import math
import warnings
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


def _position_encoding(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(n, 5): [k_pos, sin(2π·k_pos·q) for q in 1, 2, 4, 8], k_pos =
    linspace(0, 1, n), built in `dtype` as jnp builds it: 2π is rounded
    to `dtype` before the product (in bf16 a Python-float 2π would move
    the sines by up to 0.18)."""
    k_pos = torch.linspace(0.0, 1.0, n, device=device).to(dtype)
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype, device=device)
    return torch.stack([k_pos] + [torch.sin(two_pi * k_pos * q)
                                  for q in (1.0, 2.0, 4.0, 8.0)], dim=-1)


def _film(x: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """leaky_relu(x·(1+γ)+β, 0.2): x (B, C, T, W), gb = [γ, β] (B, T, 2C)
    per frame, broadcast over W."""
    gamma, beta = gb.transpose(1, 2)[..., None].chunk(2, dim=1)
    return F.leaky_relu(x * (1.0 + gamma) + beta, 0.2)


class SequenceMaskHead(nn.Module):
    """Per-frame hidden state (B, T, D) of a sequence trunk -> masks: the
    `dense`, `film` and `filmpack` branches of the JAX `MaskHead`
    (`gan_sass_tf_tpu/models/generator.py:78-177,202-207`).
    `convs[i]` is MaskHead_0/Conv_i and `denses[i]` MaskHead_0/Dense_i.

      * dense: Dense(S·K·mc) on h (learns a per-bin map).
      * film: bin-local (1, 5) convs with bin dilations 1, 2, 4 over the
        standardized input spectrogram and a fixed position encoding, each
        FiLM-modulated by Dense(2c)(h) broadcast over bins; a 1x1 conv.
      * filmpack: the same on the lane-packed relayout (B, T, K/f, f) of
        the input (K padded to a multiple of f) with (3, 3) convs; h enters
        through 1x1 convs, which on h broadcast over the cells are a dense
        on h; the f·S·mc output channels unfold back to K bins.
    """

    def __init__(self, hidden: int, num_sources: int, n_bins: int,
                 mask_type: str, mask_activation: str, noise_slot: bool,
                 head_mode: str, film_channels: int = 64, film_fold: int = 8):
        super().__init__()
        self.num_sources, self.n_bins, self.mode = num_sources, n_bins, head_mode
        self.mask_type, self.mask_activation = mask_type, mask_activation
        slots = num_sources + int(noise_slot and mask_activation == "softmax"
                                  and mask_type == "magnitude")
        self.slots, self.mc = slots, mask_channels(mask_type)
        c, f, out = film_channels, film_fold, slots * self.mc
        self.fold = f
        convs, denses = [], []
        if head_mode == "dense":
            denses = [nn.Linear(hidden, out * n_bins)]
        elif head_mode == "film":
            for i in range(3):
                convs.append(nn.Conv2d(6 if i == 0 else c, c, (1, 5)))
                denses.append(nn.Linear(hidden, 2 * c))
            convs.append(nn.Conv2d(c, out, 1))
        elif head_mode == "filmpack":
            for i in range(3):
                convs += [nn.Conv2d(f + 5 if i == 0 else c, c, 3),
                          nn.Conv2d(hidden, 2 * c, 1)]
            convs.append(nn.Conv2d(c, f * out, 1))
        else:
            raise ValueError(f"sequence head_mode must be 'dense', 'film' or "
                             f"'filmpack', got {head_mode!r}")
        self.convs, self.denses = nn.ModuleList(convs), nn.ModuleList(denses)

    def forward(self, h: torch.Tensor, x_ref: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """h (B, T, D); x_ref (B, T, K) the standardized linear-grid input
        (film heads) -> masks (B, S, T, K[, 2]) f32."""
        b, t = h.shape[:2]
        k, s, mc = self.n_bins, self.slots, self.mc
        if self.mode == "dense":
            out = _dense(self.denses[0], h, dtype).reshape(b, t, s, k, mc)
            out = out.transpose(1, 2)                       # (B, S, T, K, mc)
        elif self.mode == "film":
            x = x_ref.to(dtype)[:, None]                    # (B, 1, T, K)
            enc = _position_encoding(k, dtype, x.device).T  # (5, K)
            x = torch.cat([x, enc[None, :, None].expand(b, -1, t, -1)], dim=1)
            for i, dil in enumerate((1, 2, 4)):
                x = _conv(self.convs[i], x, dtype, dilation=(1, dil))
                x = _film(x, _dense(self.denses[i], h, dtype))
            out = _conv(self.convs[3], x, dtype)            # (B, S·mc, T, K)
            out = out.reshape(b, s, mc, t, k).permute(0, 1, 3, 4, 2)
        else:                                               # filmpack
            f = self.fold
            kp = -(-k // f) * f
            cells = kp // f
            x = F.pad(x_ref, (0, kp - k)).reshape(b, t, cells, f).to(dtype)
            enc = _position_encoding(cells, dtype, x.device)
            x = torch.cat([x, enc.expand(b, t, -1, -1)], dim=-1)
            x = x.permute(0, 3, 1, 2)                       # (B, f+5, T, cells)
            for i, dil in enumerate((1, 2, 4)):
                x = _conv(self.convs[2 * i], x, dtype, dilation=(1, dil))
                ctx = self.convs[2 * i + 1]
                x = _film(x, F.linear(h.to(dtype), ctx.weight[:, :, 0, 0].to(dtype),
                                      ctx.bias.to(dtype)))
            out = _conv(self.convs[6], x, dtype)            # (B, f·S·mc, T, cells)
            out = out.reshape(b, f, s, mc, t, cells).permute(0, 2, 4, 5, 1, 3)
            out = out.reshape(b, s, t, kp, mc)[:, :, :, :k]
        return _mask_exit(out, self.mask_type, self.mask_activation,
                          self.num_sources)


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
    `Bidirectional`.  The recurrence runs in `torch.lstm` in the compute
    dtype: weights and input cast to it, the gate matmuls accumulated in
    f32.  On the card cuDNN runs it in bf16 too (its elemWiseRNNcell
    kernels for __nv_bfloat16), though `torch.backends.cudnn.is_acceptable`
    answers False for a bf16 tensor.  In bf16 the carry differs from flax's,
    which promotes c and h to f32 between steps; here the hidden state
    between steps and layers is bf16."""

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
        self.head = SequenceMaskHead(2 * hidden, num_sources, n_bins, mask_type,
                                     mask_activation, noise_slot, head_mode,
                                     film_channels, film_fold)

    def forward(self, feats: torch.Tensor, train: bool = False) -> torch.Tensor:
        """feats (B, T, F_feat) -> masks (B, S, T, K[, 2]) f32."""
        if train and self.dropout > 0:
            raise NotImplementedError(
                "dropout at train time is not ported yet (ROADMAP.md, "
                "'Modules to port', item 9: remaining model options)")
        dt = self.dtype
        x0 = _standardize(feats.float(), dims=(1, 2))      # (B, T, F)
        weights = []
        for cell in self.cells:    # the input bias is zero: one bias a gate
            weights += [cell.weight_ih.to(dt), cell.weight_hh.to(dt),
                        cell.bias.new_zeros(cell.bias.shape, dtype=dt),
                        cell.bias.to(dt)]
        zeros = x0.new_zeros((2 * self.layers, x0.shape[0], self.hidden), dtype=dt)
        with warnings.catch_warnings():
            # cuDNN copies the weights into one buffer each call and warns;
            # they are cast to the compute dtype each call anyway.
            warnings.filterwarnings("ignore", message="RNN module weights")
            # train=True keeps what the backward needs (cuDNN's reserve space).
            h, _, _ = torch.lstm(x0.to(dt), (zeros, zeros), weights, True, self.layers,
                                 0.0, torch.is_grad_enabled(), True, True)
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

"""Conv discriminators: (mixture, candidate) log-magnitude pairs
(B, T, K, 2), or with `input_fold` f the frames folded into channels
(B, T/f, K, 2f), -> one real/fake logit per pair (B,), or per patch
(B, T', F') for the PatchGAN head, f32.

Port of `gan_sass_tf_tpu/models/discriminator.py` (`ConvDiscriminator`,
`PatchDiscriminator`): strided "SAME" convs ((2·st/f, 2·sk) stem at
stride (st/f, sk), then (4, 4) at stride (2, 2)), a norm after every conv
but the first ("batch", "group" or "none"; "spectral" normalizes every
layer's weight instead), LeakyReLU, dropout; then global average pool and
Dense(1), or a 1x1 conv per patch, in f32.  Activations are NCHW inside;
the input layout is the JAX package's.

Spectral normalization is written out, not `torch.nn.utils.spectral_norm`
(whose training-mode hook updates `u` on every forward).  It mirrors flax
0.12.3 `SpectralNorm._spectral_normalize`:

  * the kernel is viewed as a (-1, out) matrix from its HWIO layout (the
    Dense head's (C, 1) kernel too; biases are not normalized);
  * one power iteration with eps 1e-12 runs on every call, from the stored
    `u`, even when the statistics are not updated;
  * `u` and `v` are constants (stop-gradient) when sigma = v·W·uᵀ is
    computed, and sigma is differentiated through;
  * the new `u` and `sigma` are stored only when `update_stats` is set.
The (u, sigma) pairs are buffers (`u{i}`, `sigma{i}`, the head last), the
counterpart of flax's `batch_stats` collection.

The norms are flax 0.12.3's, computed by hand because torch's differ:

  * `nn.BatchNorm`: statistics in f32 over (N, T, F) with the fast
    variance max(0, E[x²] − E[x]²); epsilon 1e-5; the running statistics
    move as 0.99·old + 0.01·batch, with the BIASED batch variance
    (`F.batch_norm` stores the unbiased one and reads momentum the other
    way round).  In train mode the batch's statistics normalize; they are
    stored only with `update_stats`.
  * `nn.GroupNorm(num_groups=min(8, C))`: statistics in f32 per example
    and group, epsilon 1e-6 (torch's default is 1e-5).
Each norm's scale, bias (and BN's mean, var buffers) are `norms[i - 1]`'s,
flax's BatchNorm_{i-1} / GroupNorm_{i-1}.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan_sass_tf_tpu_torch.models.dropout import NCHW, DropoutKey, dropout_fn
from gan_sass_tf_tpu_torch.models.generator import _same_pad

SN_EPS = 1e-12
BN_MOMENTUM, BN_EPS, GN_EPS = 0.99, 1e-5, 1e-6
NORMS = ("spectral", "batch", "group", "none")


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, out) weight matrix, (1, out) stored u -> (w / sigma, new u,
    sigma): one power iteration, gradient only through sigma's W."""
    with torch.no_grad():
        v = _l2_normalize(u @ w.T)
        u_new = _l2_normalize(v @ w)
    sigma = ((v @ w) @ u_new.T)[0, 0]
    w_bar = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
    return w_bar, u_new, sigma.detach()


def stem_geometry(stem_stride: Sequence[int], input_fold: int):
    """The first conv's (kernel, stride) when f = input_fold frames arrive
    folded into channels: the time kernel and stride shrink by f, so the
    receptive field and the downsampling stay those of the unfolded stem.
    ValueError unless f divides the stem's time stride."""
    st, sk = stem_stride
    if st % input_fold != 0:
        raise ValueError(f"d_input_fold {input_fold} must divide the stem "
                         f"time-stride {st}")
    return ((2 * st) // input_fold, 2 * sk), (st // input_fold, sk)


class Norm(nn.Module):
    """flax's BatchNorm (`batch`: scale, bias; buffers mean, var) or
    GroupNorm (`group`: scale, bias) over `channels`."""

    def __init__(self, kind: str, channels: int):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if kind == "batch":
            self.register_buffer("mean", torch.zeros(channels))
            self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool, update_stats: bool) -> torch.Tensor:
        """x (N, C, T, F) -> normalized, in x's dtype."""
        xf = x.float()
        if self.kind == "group":
            n, c = x.shape[:2]
            g = xf.reshape(n, min(8, c), -1)
            mu, mu2 = g.mean(-1), (g * g).mean(-1)
            var = torch.clamp(mu2 - mu * mu, min=0.0)
            gs = c // mu.shape[1]
            mean = mu.repeat_interleave(gs, 1)[:, :, None, None]
            var = var.repeat_interleave(gs, 1)[:, :, None, None]
            eps = GN_EPS
        elif train:
            mean, mu2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp(mu2 - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                    self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
            mean, var, eps = mean[:, None, None], var[:, None, None], BN_EPS
        else:
            mean, var, eps = self.mean[:, None, None], self.var[:, None, None], BN_EPS
        mul = torch.rsqrt(var + eps) * self.scale[:, None, None]
        return ((xf - mean) * mul + self.bias[:, None, None]).to(x.dtype)


class ConvDiscriminator(nn.Module):
    """`convs[i]` is flax Conv_i (weights OIHW); `head` is Dense_0, or with
    `patch` the 1x1 Conv_L; `norms[i - 1]` BatchNorm_{i-1} or
    GroupNorm_{i-1}; with `norm="spectral"` the buffers `u{i}` /
    `sigma{i}` hold SpectralNorm_i's power-iteration state."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128),
                 norm: str = "spectral", leak: float = 0.2, dropout: float = 0.0,
                 stem_stride: Sequence[int] = (2, 4), input_fold: int = 1,
                 patch: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown norm {norm!r}")
        self.norm, self.leak, self.dropout, self.dtype = norm, leak, dropout, dtype
        self.patch = patch
        self.strides = []
        convs, cin = [], 2 * input_fold
        for i, c in enumerate(channels):
            k, s = stem_geometry(stem_stride, input_fold) if i == 0 else ((4, 4), (2, 2))
            convs.append(nn.Conv2d(cin, c, k))
            self.strides.append(s)
            cin = c
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(Norm(norm, c) for c in channels[1:]
                                   if norm in ("batch", "group"))
        self.head = nn.Conv2d(cin, 1, 1) if patch else nn.Linear(cin, 1)
        if norm == "spectral":
            for i, c in enumerate(list(channels) + [1]):
                self.register_buffer(f"u{i}", torch.zeros(1, c))
                self.register_buffer(f"sigma{i}", torch.ones(()))

    def sn_state(self):
        """[(u, sigma)] per normalized layer, the head last ([] unless the
        norm is spectral)."""
        if self.norm != "spectral":
            return []
        return [(getattr(self, f"u{i}"), getattr(self, f"sigma{i}"))
                for i in range(len(self.convs) + 1)]

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                train: bool = False, dropout: Optional[DropoutKey] = None
                ) -> torch.Tensor:
        """(B, T, K, C) pairs -> (B,) or (B, T', F') f32 logits.

        `train`: BN normalizes with the batch's statistics and dropout
        runs (site i after layer i); the train step always sets it, as the
        reference calls D with train=True.  `update_stats`: store the new
        power-iteration state (spectral) or running statistics (batch,
        with `train`)."""
        dt, spectral = self.dtype, self.norm == "spectral"
        drop = dropout_fn(self.dropout, train, dropout)
        state = self.sn_state()
        new_state = []

        def weight(layer, i, hwio):
            """layer i's weight as HWIO -> (n, out) matrix, normalized
            when spectral."""
            o = layer.weight.shape[0]
            w_mat = layer.weight.permute(*hwio).reshape(-1, o)
            if not spectral:
                return w_mat
            w_bar, u_new, sigma = spectral_normalize(w_mat, state[i][0])
            new_state.append((u_new, sigma))
            return w_bar

        x = x.permute(0, 3, 1, 2).to(dt)
        for i, (conv, stride) in enumerate(zip(self.convs, self.strides)):
            o, cin, kh, kw = conv.weight.shape
            w = weight(conv, i, (2, 3, 1, 0)).reshape(kh, kw, cin, o).permute(3, 2, 0, 1)
            pt = _same_pad(x.shape[2], kh, stride[0])
            pf = _same_pad(x.shape[3], kw, stride[1])
            x = F.pad(x, (pf[0], pf[1], pt[0], pt[1]))
            x = F.conv2d(x, w.to(dt), conv.bias.to(dt), stride)
            if i > 0 and self.norms:
                x = self.norms[i - 1](x, train, update_stats)
            x = drop(F.leaky_relu(x, self.leak), i, NCHW)
        x = x.float()                   # logits in f32
        if self.patch:
            w = weight(self.head, len(self.convs), (2, 3, 1, 0))
            logits = F.conv2d(x, w.T[:, :, None, None], self.head.bias)[:, 0]
        else:
            w = weight(self.head, len(self.convs), (1, 0))
            logits = (x.mean(dim=(2, 3)) @ w + self.head.bias)[:, 0]
        if update_stats and spectral:
            with torch.no_grad():
                for (u, s), (u_new, s_new) in zip(state, new_state):
                    u.copy_(u_new)
                    s.copy_(s_new)
        return logits


class PatchDiscriminator(ConvDiscriminator):
    """A ConvDiscriminator with the PatchGAN head: one logit per patch
    (B, T', F') from a 1x1 conv (`patch=True` fixed)."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128), **kwargs):
        super().__init__(channels, patch=True, **kwargs)


"""Spectral-norm conv discriminator: (mixture, candidate) log-magnitude pairs
(B, T, K, 2) -> one real/fake logit per pair, f32.

Port of `gan_sass_tf_tpu/models/discriminator.py::ConvDiscriminator` with
`norm="spectral"`: strided "SAME" convs ((2·st, 2·sk) stem at stride
(st, sk), then (4, 4) at stride (2, 2)), LeakyReLU, global average pool,
Dense(1) head in f32.  Activations are NCHW inside; the input layout is the
JAX package's.

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
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan_sass_tf_tpu_torch.models.generator import _same_pad

SN_EPS = 1e-12


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


class ConvDiscriminator(nn.Module):
    """`convs[i]` is flax Conv_i (weights OIHW), `head` is Dense_0; buffers
    `u{i}` / `sigma{i}` hold SpectralNorm_i's power-iteration state."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128),
                 leak: float = 0.2, stem_stride: Sequence[int] = (2, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.leak, self.dtype = leak, dtype
        self.strides = []
        convs, cin = [], 2
        for i, c in enumerate(channels):
            s = tuple(stem_stride) if i == 0 else (2, 2)
            convs.append(nn.Conv2d(cin, c, (2 * s[0], 2 * s[1])))
            self.strides.append(s)
            cin = c
        self.convs = nn.ModuleList(convs)
        self.head = nn.Linear(cin, 1)
        for i, c in enumerate(list(channels) + [1]):
            self.register_buffer(f"u{i}", torch.zeros(1, c))
            self.register_buffer(f"sigma{i}", torch.ones(()))

    def sn_state(self):
        """[(u, sigma)] per normalized layer, the head last."""
        return [(getattr(self, f"u{i}"), getattr(self, f"sigma{i}"))
                for i in range(len(self.convs) + 1)]

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        """(B, T, K, 2) pairs -> (B,) f32 logits."""
        dt = self.dtype
        state = self.sn_state()
        new_state = []
        x = x.permute(0, 3, 1, 2).to(dt)
        for conv, stride, (u, _) in zip(self.convs, self.strides, state):
            o, i, kh, kw = conv.weight.shape
            w_mat = conv.weight.permute(2, 3, 1, 0).reshape(-1, o)       # HWIO
            w_bar, u_new, sigma = spectral_normalize(w_mat, u)
            new_state.append((u_new, sigma))
            w = w_bar.reshape(kh, kw, i, o).permute(3, 2, 0, 1)
            pt = _same_pad(x.shape[2], kh, stride[0])
            pf = _same_pad(x.shape[3], kw, stride[1])
            x = F.pad(x, (pf[0], pf[1], pt[0], pt[1]))
            x = F.conv2d(x, w.to(dt), conv.bias.to(dt), stride)
            x = F.leaky_relu(x, self.leak)
        x = x.mean(dim=(2, 3)).float()                   # global average pool
        w_bar, u_new, sigma = spectral_normalize(self.head.weight.T, state[-1][0])
        new_state.append((u_new, sigma))
        logits = x @ w_bar + self.head.bias
        if update_stats:
            with torch.no_grad():
                for (u, s), (u_new, s_new) in zip(state, new_state):
                    u.copy_(u_new)
                    s.copy_(s_new)
        return logits[:, 0]


def init_params_(d: ConvDiscriminator, generator: torch.Generator) -> ConvDiscriminator:
    """Seeded init in place: kernels normal with std 1/sqrt(fan_in), zero
    biases, u standard normal, sigma 1 (flax's SpectralNorm init)."""
    with torch.no_grad():
        for m in list(d.convs) + [d.head]:
            fan_in = math.prod(m.weight.shape[1:])
            nn.init.normal_(m.weight, 0.0, fan_in ** -0.5, generator=generator)
            nn.init.zeros_(m.bias)
        for u, s in d.sn_state():
            u.normal_(generator=generator)
            s.fill_(1.0)
    return d

"""Streaming chunked separation: any length, in hop-aligned overlapping
chunks.

Port of `gan_sass_tf_tpu/infer/streaming.py`.  The batched path spreads
each chunk group over the ranks of a process group, as the reference's
`shard_map` over its mesh; the scan path runs on one device.

  1. The host slices the mixture into chunks of stream.chunk_seconds on the
     STFT frame grid, overlapping by stream.overlap_frames hops.
  2. Each chunk goes through the one-shot separation graph (K1, G, K2):
     `separate_streaming` in groups of stream.batch_chunks chunks (one
     launch of each kernel a group), `separate_streaming_scan` one chunk at
     a time, carrying the previous chunk's overlap tail.
  3. A PIT net has no canonical source order, so each chunk's sources are
     permuted to match the previous chunk's on the overlap (L2 over all S!
     permutations), keeping the previous assignment unless another one
     wins by stream.perm_hysteresis of the stream's loudness.
  4. A linear cross-fade and overlap-add join the chunks on the device.

The batched path makes three host-device crossings (one upload of all
chunks, one fetch of the overlap strips for the chaining on the host, one
fetch of the joined waveforms); the scan path chooses each permutation on
the device and fetches once at the end.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np
import torch

from gan_sass_tf_tpu_torch.dsp.stft import overlap_add
from gan_sass_tf_tpu_torch.losses.pit import permutations_for
from gan_sass_tf_tpu_torch.parallel.mesh import data_parallel
from gan_sass_tf_tpu_torch.train.step import build_separate_fn


def _chunk_geometry(cfg, total: int):
    """(chunk, stride, overlap, n_chunks, padded, ext) for a mixture of
    `total` samples."""
    sr, hop, n_fft = cfg.dsp.sample_rate, cfg.dsp.hop_length, cfg.dsp.n_fft
    chunk = int(cfg.stream.chunk_seconds * sr)
    chunk = max(n_fft, n_fft + ((chunk - n_fft) // hop) * hop)  # frame grid
    overlap = cfg.stream.overlap_frames * hop
    if overlap >= chunk:
        raise ValueError(f"overlap {overlap} >= chunk {chunk}")
    stride = chunk - overlap
    n_chunks = max(1, -(-(total - overlap) // stride))
    # win_length < n_fft: the iSTFT cannot reconstruct the last
    # n_fft - win_length samples of any segment (no analysis frame covers
    # them; separate() zero-pads there).  Each chunk therefore READS a
    # hop-aligned extension beyond its overlap-add span and its output is
    # cropped back to `chunk`, so the silent tail never enters the fade.
    ext = cfg.dsp.n_fft - cfg.dsp.win_length
    if ext:
        ext = -(-ext // hop) * hop
    padded = n_chunks * stride + overlap + ext
    return chunk, stride, overlap, n_chunks, padded, ext


def _chain_permutations(heads: np.ndarray, tails: np.ndarray,
                        hysteresis: float,
                        scale: Optional[float] = None) -> np.ndarray:
    """heads/tails (N, S, overlap) -> (N, S) per-chunk source permutation
    that aligns each chunk to the previous chunk's aligned tail on their
    shared overlap: a greedy chain over all S! permutations.

    `hysteresis`: keep the previous chunk's assignment unless another
    permutation lowers the L2 by more than hysteresis * scale * (S *
    overlap).  `scale` is the stream's mean squared amplitude (callers pass
    the whole chunks' statistic; default the strips' own), so that a
    near-silent overlap, which carries no matching evidence, cannot flip
    the sources on noise-level L2 differences."""
    n, s, _ = heads.shape
    out = np.tile(np.arange(s), (n, 1))
    if s == 1 or n == 1 or heads.shape[-1] == 0:
        return out
    if scale is None:
        scale = float(np.mean(heads ** 2) + np.mean(tails ** 2)) / 2.0
    margin = hysteresis * scale * s * heads.shape[-1]
    perms = list(itertools.permutations(range(s)))
    for i in range(1, n):
        prev_tail = tails[i - 1][out[i - 1]]         # aligned (S, overlap)
        head = heads[i]                              # (S, overlap)
        errs = {p: float(np.sum((head[list(p)] - prev_tail) ** 2))
                for p in perms}
        best = min(errs, key=errs.get)
        keep = tuple(out[i - 1])                     # previous assignment
        out[i] = best if errs[best] < errs[keep] - margin else keep
    return out


def _align_chunk_permutations(chunks: np.ndarray, stride: int, overlap: int,
                              hysteresis: float) -> np.ndarray:
    """chunks (N, S, T_c): each chunk's sources reordered to match the
    previous chunk on their shared overlap (a host-array wrapper around
    _chain_permutations)."""
    perm = _chain_permutations(chunks[:, :, :overlap],
                               chunks[:, :, stride : stride + overlap],
                               hysteresis,
                               scale=float(np.mean(chunks ** 2)))
    return np.take_along_axis(chunks, perm[:, :, None], axis=1)


def _fade_ramp(overlap: int, device) -> torch.Tensor:
    """The fade-in weights 1/(overlap+1) .. overlap/(overlap+1), f32."""
    return torch.arange(1, overlap + 1, dtype=torch.float32,
                        device=device) / (overlap + 1)


def _finalize_stream(est: torch.Tensor, perm: torch.Tensor, stride: int,
                     overlap: int) -> torch.Tensor:
    """(N, S, T_c) chunk outputs + (N, S) source permutations -> (S, T)
    joined waveforms, on est's device: the permutation gather, linear
    cross-fade weights and the overlap-add."""
    n, s, t_c = est.shape
    est = torch.gather(est, 1, perm[:, :, None].long().expand(n, s, t_c))
    w = torch.ones((n, t_c), dtype=torch.float32, device=est.device)
    if overlap:
        ramp = _fade_ramp(overlap, est.device)
        w[1:, :overlap] = ramp
        w[:-1, t_c - overlap:] = ramp.flip(0)
    frames = (est * w[:, None, :]).transpose(0, 1)       # (S, N, T_c)
    if t_c % stride == 0:
        return overlap_add(frames, stride)
    full = torch.zeros((s, (n - 1) * stride + t_c), dtype=est.dtype,
                       device=est.device)
    for i in range(n):
        full[:, i * stride : i * stride + t_c] += frames[:, i]
    return full


def _chunk_matrix(cfg, mixture: np.ndarray):
    """(T,) mixture -> (N, chunk + ext) overlapping chunks of the padded
    stream (the frame-and-stride gather) and the geometry."""
    mixture = np.asarray(mixture, np.float32)
    if mixture.ndim != 1:
        raise ValueError("streaming separation takes a single (T,) waveform")
    geom = _chunk_geometry(cfg, mixture.shape[-1])
    chunk, stride, overlap, n_chunks, padded, ext = geom
    idx = (np.arange(n_chunks)[:, None] * stride
           + np.arange(chunk + ext)[None, :])
    wav = np.pad(mixture, (0, padded - mixture.shape[-1]))
    return wav[idx], geom


@torch.inference_mode()
def separate_streaming(g: Optional[torch.nn.Module], cfg, mixture: np.ndarray,
                       device,
                       separate_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                       ) -> np.ndarray:
    """Long mixture (T,) float32 -> (S, T) separated sources, in groups of
    stream.batch_chunks chunks on `device`.  `separate_fn` (default
    `build_separate_fn(cfg, g)`) maps a (B, T_c) chunk batch on the device
    to (B, S, T_c) waveforms.  Inside a process group each rank separates
    its batch_chunks / world chunks of a group and gathers the others';
    every rank returns the whole result."""
    t_in = np.asarray(mixture).shape[-1]
    chunks, (chunk, stride, overlap, n_chunks, _, _) = _chunk_matrix(cfg, mixture)
    if separate_fn is None:
        separate_fn = build_separate_fn(cfg, g)
    bc = cfg.stream.batch_chunks
    dp = data_parallel(cfg.mesh, bc, what="stream.batch_chunks")
    mine = dp.batch_rows(bc)
    n_groups = -(-n_chunks // bc)
    # Zero chunks fill the last group; their outputs are dropped below.
    chunks_pad = np.pad(chunks, ((0, n_groups * bc - n_chunks), (0, 0)))
    chunks_dev = torch.from_numpy(np.ascontiguousarray(
        chunks_pad.reshape(n_groups, bc, -1)[:, mine])).to(device)
    est = torch.cat([dp.all_gather(separate_fn(chunks_dev[gi])[..., :chunk])
                     for gi in range(n_groups)])[:n_chunks]    # (N, S, chunk)
    strips = torch.cat([est[:, :, :overlap], est[:, :, stride : stride + overlap]],
                       dim=-1).cpu().numpy()                   # (N, S, 2*overlap)
    # The margin's scale is the INPUT stream's loudness: the separated
    # strips can be near-silent exactly where matching evidence vanishes,
    # which is where the margin must hold.
    perm = _chain_permutations(strips[..., :overlap], strips[..., overlap:],
                               cfg.stream.perm_hysteresis,
                               scale=float(np.mean(chunks ** 2)))
    full = _finalize_stream(est, torch.from_numpy(perm).to(est.device), stride,
                            overlap)
    return full.cpu().numpy()[..., :t_in]


@torch.inference_mode()
def separate_streaming_scan(g: Optional[torch.nn.Module], cfg,
                            mixture: np.ndarray, device) -> np.ndarray:
    """Long mixture (T,) float32 -> (S, T) separated sources, one chunk at a
    time on `device`, each chunk's output final once the next chunk's head
    has been faded against its tail.

    The loop carries the previous chunk's overlap tail, its permutation
    index and the stream's loudness so far (the running max of each
    chunk's power): the hysteresis margin scales with that loudness, so a
    wholly silent chunk inside a pause cannot zero it.  The permutation is
    chosen on the device (argmin and where over the S! permutations), so
    the loop never waits for the device.  Chunk 0 keeps full weight and
    its own source order, as in the batched path.  (The JAX package matches
    it against the zero initial carry, a tie of all S! permutations that
    its float rounding may break either way at hysteresis 0.)"""
    t_in = np.asarray(mixture).shape[-1]
    chunks, (_, stride, overlap, _, _, ext) = _chunk_matrix(cfg, mixture)
    full = scan_chunks(build_separate_fn(cfg, g), cfg,
                       torch.from_numpy(chunks).to(device), stride, overlap, ext)
    return full.cpu().numpy()[..., :t_in]


@torch.inference_mode()
def scan_chunks(separate: Callable[[torch.Tensor], torch.Tensor], cfg,
                chunks_dev: torch.Tensor, stride: int, overlap: int,
                ext: int) -> torch.Tensor:
    """The scan of `separate_streaming_scan` over (N, chunk + ext) chunks
    already on the device: the (S, T_full) stream on the device, the
    loop never waiting for it."""
    n_chunks = chunks_dev.shape[0]
    s = cfg.data.num_sources
    dev = chunks_dev.device
    perms = torch.from_numpy(permutations_for(s)).long().to(dev)   # (P, S)
    hyst = float(cfg.stream.perm_hysteresis)
    t_c = chunks_dev.shape[-1] - ext            # overlap-add span of a chunk
    ramp = _fade_ramp(overlap, dev)
    tail = torch.zeros((s, overlap), dtype=torch.float32, device=dev)
    prev = torch.zeros((), dtype=torch.long, device=dev)     # identity
    loud = torch.zeros((), dtype=torch.float32, device=dev)
    segs = []
    for i in range(n_chunks):
        chunk = chunks_dev[i]
        wavs = separate(chunk[None])[0][:, :t_c]                # (S, T_c)
        loud = torch.maximum(loud, chunk.square().mean())
        if i:
            errs = (wavs[:, :overlap][perms] - tail).square().sum(dim=(1, 2))
            best = torch.argmin(errs)
            margin = hyst * loud * (s * overlap)
            prev = torch.where(errs[best] < errs[prev] - margin, best, prev)
        wavs = wavs[perms[prev]]
        head = wavs[:, :overlap]
        faded = head if i == 0 else tail * (1.0 - ramp) + head * ramp
        segs.append(torch.cat([faded, wavs[:, overlap:stride]], dim=-1))
        tail = wavs[:, stride:]
    return torch.cat([torch.stack(segs, dim=1).reshape(s, -1), tail], dim=-1)

"""K2: fused mask-apply + iSTFT/overlap-add — the CUDA kernel's wrapper and
its plain PyTorch version, and the synthesis body's launch plan, which K3
(`ops/istft.py`) shares.

Port of `gan_sass_tf_tpu/ops/pallas_istft.py::masked_istft_pallas`:
mixture STFT (..., F, K) + masks (..., S, F, K[, 2]) -> (..., S, T) wavs.
`masked_istft_kernel` launches `csrc/masked_istft.cu` (persistent blocks,
each frame inverted once in registers, n_fft a power of two from 64 to
4096) on CUDA tensors; `masked_istft_reference` is `apply_mask` followed by
`istft(norm="global")`.  `ops.dispatch` chooses between them by the
tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from gan_sass_tf_tpu_torch.dsp.masks import apply_mask
from gan_sass_tf_tpu_torch.dsp.stft import irfft, istft as _istft, overlap_add
from gan_sass_tf_tpu_torch.dsp.windows import cola_norm, get_window, safe_inv_env
from gan_sass_tf_tpu_torch.ops.stft_features import analysis_tables, check_n_fft

# The synthesis body's block shape (K2 and K3).  Threads a block: 0 lets
# synthesis_threads pick among THREAD_CHOICES.  Frames a tile: 0 takes as
# many as one round of the block's frame slots holds (threads/(n_fft/32)
# slots, shared by a work item's sources), fewer where shared memory runs
# out.  At most BLOCKS_PER_SM persistent blocks share an SM.  Segment rows:
# 0 lets synthesis_segment pick.  Picked on an H100 by
# gan_sass_tf_tpu_torch/scripts/time_synthesis.py --sweep (PERF.md); the
# output's bits do not depend on any of them.
THREADS = 0
THREAD_CHOICES = (256, 512)
TILE_FRAMES = 0
BLOCKS_PER_SM = 2
SEGMENT_ROWS = 0

# What a work item reads beside the spectrum (csrc/masked_istft.cu SpecInput).
SPEC_ONLY, MAGNITUDE_MASK, COMPLEX_MASK = 0, 1, 2

launches = 0   # kernel launches since the last reset (chip_smoke reads it)


class _Plan(ctypes.Structure):
    """csrc/masked_istft.cu's Plan: a call's geometry, tables and block
    shape, built once per geometry and passed to every launch."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("win", "tw", "tws", "ptw", "inv_env")]
                + [(n, ctypes.c_int) for n in (
                    "B", "S", "F", "n_fft", "hop", "input", "threads", "tile_frames",
                    "sources", "seg_rows", "per_sm", "device", "smem", "sms", "fit",
                    "grid")])


def synthesis_segment(signals: int, nrows: int, r: int, tile: int,
                      blocks: int) -> int:
    """Output hop-rows a work item owns, for `signals` rows of work items
    (mixtures × source groups) of `nrows` hop-rows each, r = n_fft/hop
    frames a row, `tile` frames a tile and `blocks` resident blocks: each
    signal cut into as many segments as fill the blocks once (blocks //
    signals, at least one), then each segment lengthened to end on a whole
    tile (its rows + r - 1 frames a multiple of `tile`).  Many signals give
    long segments, whose r - 1 re-inverted halo frames are a few per cent;
    one streaming chunk gives short ones, spread over many SMs."""
    per_signal = max(1, blocks // signals)
    seg = -(-nrows // per_signal)
    tiles = -(-(seg + r - 1) // tile)
    return min(nrows, tiles * tile - (r - 1))


def synthesis_load(signals: int, nrows: int, r: int, tile: int, slots: int,
                   seg: int, grid: int, sms: int) -> int:
    """The frame slots the busiest SM runs: work item i (a segment of one
    signal) goes to block i mod grid and block b to SM b mod sms, and an
    item costs a round of `slots` frame slots a tile of `tile` frames."""
    f = nrows - r + 1
    tiles = [-(-(min(f, q0 + seg) - max(0, q0 - r + 1)) // tile)
             for q0 in range(0, nrows, seg)] * signals
    load = [0] * min(grid, sms)
    for i, n in enumerate(tiles):
        load[(i % grid) % sms] += n * slots
    return max(load)


def synthesis_threads(loads: dict) -> int:
    """The block size whose plan loads the busiest SM least ({threads:
    synthesis_load}); on a tie the larger, whose warps hide more latency."""
    return min(sorted(loads, reverse=True), key=lambda n: loads[n])


@functools.lru_cache(maxsize=16)
def _inv_env(n_fft: int, hop: int, window: str, n_frames: int,
             device: torch.device) -> torch.Tensor:
    """safe_inv_env(cola_norm(w, hop, F)) on `device`, length (F-1)·hop + n_fft."""
    w = get_window(window, n_fft)
    return torch.from_numpy(safe_inv_env(cola_norm(w, hop, n_frames))).to(device)


def _prepare(spec_input: int, b: int, s: int, f: int, n_fft: int, hop: int,
             window: str, env: str, device: torch.device, threads: int,
             tile: int, per_sm: int, seg_rows: int):
    """(plan, the tensors it points at, the busiest SM's frame slots) at one
    block size: the library checks the geometry and picks the sources a
    work item takes and the frames a tile (`synthesis_prepare`); the
    segment (`synthesis_segment` unless `seg_rows`) and the grid (as many
    blocks as there are items, at most SMs × min(blocks that fit, per_sm))
    are set here."""
    from gan_sass_tf_tpu_torch.ops import build

    tables = analysis_tables(n_fft, window, device)
    inv = _inv_env(n_fft, hop, window, f, device) if env == "full" else None
    plan = _Plan(*(t.data_ptr() for t in tables), None if inv is None else inv.data_ptr(),
                 b, s, f, n_fft, hop, spec_input, threads, tile, 0, 0, per_sm,
                 device.index, 0, 0, 0, 0)
    build.check_launch(build.load_library().synthesis_prepare(ctypes.addressof(plan)),
                       "synthesis_prepare")
    r, nrows = n_fft // hop, f + n_fft // hop - 1
    signals = b * -(-s // plan.sources)
    blocks = plan.sms * min(plan.fit, per_sm)
    plan.seg_rows = seg_rows or synthesis_segment(signals, nrows, r, plan.tile_frames,
                                                  blocks)
    plan.grid = min(signals * -(-nrows // plan.seg_rows), blocks)
    load = synthesis_load(signals, nrows, r, plan.tile_frames,
                          threads // (n_fft // 32), plan.seg_rows, plan.grid, plan.sms)
    return plan, (tables, inv), load


@functools.lru_cache(maxsize=64)
def synthesis_plan(spec_input: int, b: int, s: int, f: int, n_fft: int,
                   hop: int, window: str, env: str, device: torch.device,
                   threads: int, tile: int, per_sm: int, seg_rows: int):
    """(plan, its address, the tensors it points at) for one geometry and
    block shape, built once; threads 0: the plan of THREAD_CHOICES that
    `synthesis_threads` picks.  Raises RuntimeError where the library
    refuses every block size."""
    choices = (threads,) if threads else THREAD_CHOICES
    plans, errors = {}, []
    for n in choices:
        try:
            plans[n] = _prepare(spec_input, b, s, f, n_fft, hop, window, env, device,
                                n, tile, per_sm, seg_rows)
        except RuntimeError as e:   # a tile no round of n threads holds
            errors.append(e)
    if not plans:
        raise errors[0]
    plan, keep, _ = plans[synthesis_threads({n: p[2] for n, p in plans.items()})]
    return plan, ctypes.addressof(plan), keep


def plan_for(spec_input: int, b: int, s: int, f: int, n_fft: int, hop: int,
             window: str, env: str, device: torch.device):
    """The memoised plan of a call at the module's block shape."""
    return synthesis_plan(spec_input, b, s, f, n_fft, hop, window, env, device,
                          THREADS, TILE_FRAMES, BLOCKS_PER_SM, SEGMENT_ROWS)


def _check_mask_type(mask_type: str, env: str) -> None:
    if mask_type not in ("magnitude", "complex"):
        raise ValueError(f"unknown mask_type {mask_type!r}")
    if env not in ("full", "none"):
        raise ValueError(f"unknown env {env!r}")


def masked_istft_reference(spec: torch.Tensor, masks: torch.Tensor,
                           n_fft: int, hop: int, window: str = "hann",
                           mask_type: str = "magnitude",
                           length: Optional[int] = None,
                           env: str = "full") -> torch.Tensor:
    """Plain version: apply_mask then istft(norm="global"); env="none" skips
    the envelope (raw windowed overlap-add)."""
    _check_mask_type(mask_type, env)
    est = apply_mask(spec, masks, mask_type)
    if env == "full":
        return _istft(est, n_fft, hop, window, length, norm="global")
    w = torch.from_numpy(get_window(window, n_fft)).to(spec.device)
    y = overlap_add(irfft(est, n_fft) * w, hop)
    return y if length is None else y[..., :length]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"masked_istft kernel: {msg}")


@functools.lru_cache(maxsize=64)
def _k2_call(spec_shape: torch.Size, spec_dtype: torch.dtype, masks_shape: torch.Size,
             masks_dtype: torch.dtype, n_fft: int, hop: int, mask_type: str,
             env: str) -> Tuple[int, int, int]:
    """(B, S, F) of a K2 call, after the checks its shapes and types need
    (ValueError otherwise), once per signature: a call's host time is the
    launch's, not its checks'."""
    _check_mask_type(mask_type, env)
    check_n_fft(n_fft, hop, _require)
    _require(spec_dtype == torch.complex64, f"needs a complex64 spectrum, got {spec_dtype}")
    _require(masks_dtype == torch.float32, f"needs f32 masks, got {masks_dtype}")
    _require(len(spec_shape) >= 2, "needs a (..., F, K) spectrum")
    *lead, f, k = spec_shape
    _require(k == n_fft // 2 + 1, f"expected {n_fft // 2 + 1} bins, got {k}")
    nl = len(lead)
    tail = (f, k, 2) if mask_type == "complex" else (f, k)
    _require(len(masks_shape) == nl + 1 + len(tail)
             and masks_shape[:nl] == spec_shape[:nl]
             and tuple(masks_shape[nl + 1:]) == tail,
             f"{mask_type} masks must be (..., S) + {tail} for a spectrum "
             f"{tuple(spec_shape)}, got {tuple(masks_shape)}")
    b, s = math.prod(lead), masks_shape[nl]
    _require(b * s > 0, f"batch {b} x sources {s}: nothing to synthesize")
    return b, s, f


def masked_istft_kernel(spec: torch.Tensor, masks: torch.Tensor,
                        n_fft: int, hop: int, window: str = "hann",
                        mask_type: str = "magnitude",
                        length: Optional[int] = None,
                        env: str = "full") -> torch.Tensor:
    """complex64 (..., F, K) spectrum + f32 masks on CUDA -> (..., S, T)
    waveforms from one launch of the CUDA kernel."""
    global launches
    from gan_sass_tf_tpu_torch.ops import build

    b, s, f = _k2_call(spec.shape, spec.dtype, masks.shape, masks.dtype, n_fft, hop,
                       mask_type, env)
    dev = spec.device
    if not (spec.is_cuda and masks.device == dev):
        _require(False, f"needs CUDA tensors on one device, got {dev} and {masks.device}")
    if not (spec.is_contiguous() and masks.is_contiguous()):
        _require(False, "needs contiguous spectrum and masks")
    _, addr, _ = plan_for(COMPLEX_MASK if mask_type == "complex" else MAGNITUDE_MASK,
                          b, s, f, n_fft, hop, window, env, dev)
    out = torch.empty((b, s, (f - 1) * hop + n_fft), dtype=torch.float32, device=dev)
    rc = build.load_library().masked_istft_launch(
        addr, spec.data_ptr(), masks.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(rc, "masked_istft")
    launches += 1
    if length is not None:
        out = out[..., :length]
    return out.reshape(*spec.shape[:-2], s, out.shape[-1])

"""The port's own copy of `gan_sass_tf_tpu/config.py`: the same dataclasses,
presets, `get_config`, `list_configs` and helpers, unchanged in content,
so that the port imports nothing of the JAX package.  The tests hold
every preset equal to the original (`tests/test_torch_config.py`).

The original's docstring follows.

Typed config system + registry with the five contract workload presets.

TPU-native replacement for the reference's hparams constants module
(reference layer L1, SURVEY.md §1.1; the reference repo family uses a
module-level constants file + registry decorators — reference structure was
unmountable, so the binding spec is BASELINE.json:6-12, whose five workload
configs become the five named presets here):

    2src_toy_cpu      BASELINE.json:7  — 2-source magnitude-mask toy (CPU-runnable)
    wsj0_logmel       BASELINE.json:8  — log-mel frontend, deeper conv G/D
    3src_pit          BASELINE.json:9  — 3-source PIT adversarial + L1
    music_complex_44k BASELINE.json:10 — complex-STFT masks at 44.1 kHz
    stream_v5e8       BASELINE.json:11 — streaming chunked inference, v5e-8 pjit

All configs are frozen dataclasses so they are hashable → usable as jit
static args, and trivially serializable into checkpoints for reproducibility
(SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple


# ---------------------------------------------------------------------------
# Leaf configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DSPConfig:
    """Audio frontend parameters (reference layer L3)."""

    sample_rate: int = 8000
    n_fft: int = 256
    hop_length: int = 64
    win_length: int = 256          # analysis window support; win_length <
    #                                n_fft follows tf.signal (window zero-
    #                                padded to the FFT size; n_frames =
    #                                1 + (T - win_length)//hop)
    window: str = "hann"           # periodic Hann (matches tf.signal default)
    feature: str = "logmag"        # "logmag" | "logmel"
    n_mels: int = 80
    mask_type: str = "magnitude"   # "magnitude" | "complex"
    mask_activation: str = "sigmoid"  # "sigmoid" | "softmax" (over sources)
    mask_noise_slot: bool = False  # softmax only: emit S+1 slots, discard the
    #                                last — a sink for mixture noise that
    #                                sum-to-1 masks over real sources cannot
    #                                suppress (the 3src hard protocol adds
    #                                noise at 10 dB SNR; without the slot the
    #                                softmax head must assign it to a source)
    eps: float = 1e-8
    backend: str = "auto"          # "auto" | "pallas" | "xla" DSP kernel backend

    def __post_init__(self):
        if self.win_length > self.n_fft:
            raise ValueError(
                f"win_length {self.win_length} > n_fft {self.n_fft}: "
                "tf.signal zero-pads the frame to the FFT size, so "
                "win_length must be <= n_fft"
            )
        if self.mask_noise_slot and (self.mask_activation != "softmax"
                                     or self.mask_type != "magnitude"):
            raise ValueError(
                "mask_noise_slot requires mask_activation='softmax' and "
                "mask_type='magnitude' (sigmoid masks can already suppress "
                "noise bin-wise; complex tanh masks have no slot axis to "
                "drop)"
            )

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def feature_dim(self) -> int:
        return self.n_mels if self.feature == "logmel" else self.n_bins


@dataclass(frozen=True)
class ModelConfig:
    """Generator/discriminator selection + sizes (reference layer L5)."""

    generator: str = "conv"        # registry key: "toy" | "conv" | "bilstm"
    discriminator: str = "conv"    # registry key
    g_channels: Tuple[int, ...] = (32, 64, 128)
    g_hidden: int = 256            # BiLSTM hidden / toy MLP width
    g_layers: int = 2              # BiLSTM stack depth
    g_time_stride: bool = True     # conv U-Net downsamples T as well as F
    g_stem_stride: Tuple[int, int] = (1, 1)  # (T, F) grid reduction by a
    #                                strided stem conv BEFORE the U-Net
    #                                (kernel = 2x stride); masks are restored
    #                                to the full (T, K) grid by a subpixel
    #                                head.  (1,1) = off.  The whole U-Net
    #                                then runs on the reduced grid — the
    #                                G-side mirror of the D-stem trick (the
    #                                decoder at full (T, K) with fat channels
    #                                dominates the music-preset step).
    g_stem_mode: str = "conv"      # "conv": strided stem conv (decimating —
    #                                measured −3 dB SI-SDRi at the music
    #                                geometry); "fold": lossless
    #                                space-to-depth relayout of each
    #                                (st, sf) cell into channels.
    g_head_mode: str = "dense"     # mask head when F_feat != n_bins (mel
    #                                frontends): "dense" = learned
    #                                per-position mel→bin map (memorizes
    #                                trained pitch positions — measured
    #                                12.5 dB held-out gap on wsj0_logmel);
    #                                "interp" = FIXED mel-warp resample +
    #                                1x1 conv (position-free weights).
    #                                For the bilstm trunk: "dense" (hidden→K
    #                                projection) or "film" (bin-local convs
    #                                over the input grid, FiLM-modulated by
    #                                the hidden state — position-free).
    #                                For folded conv trunks (g_stem_stride
    #                                != (1,1)): "fold" = emit all (st,sf)
    #                                sub-position mask logits per cell ON
    #                                the folded grid (folded full-res input
    #                                skip; depth-to-space only on the mask
    #                                tensor) — no full-grid hidden tensor
    #                                is materialized (round-5 physical
    #                                ledger: the subpixel restore's <=33-ch
    #                                full-grid tensors pad 4x to the
    #                                128-lane tile).
    g_film_channels: int = 64      # width of the "film" head's dilated
    #                                bin-local conv stack
    g_film_fold: int = 8           # conv-trunk "film" head only: lane-packing
    #                                factor — the head runs on a
    #                                (T, K/f, f·C) relayout of the full-grid
    #                                input so its activations FILL the 128
    #                                MXU lanes instead of padding them (a
    #                                full-grid C<=64 tensor pads to 128
    #                                lanes; measured channel-insensitivity
    #                                on music proves the padding dominates).
    #                                Full per-bin information is preserved;
    #                                weights are position-free across cells
    #                                (periodic within one f-cell).
    g_remat: bool = False          # rematerialize G's forward inside the
    #                                train step's backward pass
    #                                (jax.checkpoint around g.apply): the
    #                                step stashes no G intermediate
    #                                activations in HBM and recomputes them
    #                                during the G backward instead.
    #                                Function-class EXACT (same math, same
    #                                numbers) — a pure FLOPs-for-bandwidth
    #                                trade for HBM-bound presets with idle
    #                                MXU (the round-4 roofline measures
    #                                every preset HBM-bound; music at 23%
    #                                MXU / 79% HBM).
    g_phase_ct: bool = False       # conv G decoder upsampling via the
    #                                phase-decomposed ConvTranspose
    #                                (models/phase_ct.py): function-class
    #                                EXACT vs nn.ConvTranspose (same params,
    #                                taps regrouped into a stride-1 conv +
    #                                depth-to-space), but the autodiff
    #                                backward has no lhs-dilated conv, so
    #                                XLA stops materializing pad+reverse of
    #                                full-grid cotangents (the round-5
    #                                bytes ledger's largest removable item).
    g_crop_nyquist: bool = False   # conv G: run on the even K-1 bin grid,
    #                                copy the top bin's mask from its
    #                                neighbor — n_bins = n_fft/2+1 is odd,
    #                                which pads every full-grid tensor's
    #                                TPU tiling; the Nyquist bin carries
    #                                negligible energy.
    g_decoder_slim: float = 1.0    # channel multiplier on the U-Net decoder
    #                                (ConvTranspose + post-concat convs).
    #                                The decoder carries ~85% of G's MACs at
    #                                the music geometry; 0.5 halves it while
    #                                keeping full (T, K) resolution.
    g_dec_l0: str = "conv"         # conv G final (full-grid) decoder stage:
    #                                "conv" = ConvTranspose + 3x3 conv at the
    #                                full (T, K) grid; "subpixel" = 1x1
    #                                expansion at the half grid +
    #                                depth-to-space (channels <=128 pad to
    #                                the 128 MXU lanes, so the full-grid
    #                                3x3 pair carries ~45% of G's effective
    #                                MACs at the music geometry for ~7% of
    #                                the cost; per-bin detail re-enters
    #                                through the encoder skip).
    d_channels: Tuple[int, ...] = (32, 64, 128)
    d_input_fold: int = 1          # fold this many time-frames into the D
    #                                input's channel dim ((B·S, T/f, K, 2f)
    #                                instead of (B·S, T, K, 2)); the stem
    #                                conv shrinks accordingly so the
    #                                function class is unchanged.  2 avoids
    #                                the 2-channel-tensor TPU layouts
    d_stem_stride: Tuple[int, int] = (2, 4)  # D first-conv (T, F) stride,
    #                                kernel = 2x stride.  (2,4)/(4,8) is the
    #                                TPU-fast stem (the 2-channel input conv
    #                                dominates the step otherwise); (2,2)
    #                                restores the classic (4,4) stem
    d_norm: str = "batch"          # "batch" | "group" | "spectral" | "none";
    #                                "spectral" (+ d_lr=1e-4) is the
    #                                recommended setting when the adversarial
    #                                term matters — default BN-D saturates on
    #                                synthetic tasks (see BASELINE.md)
    leak: float = 0.2              # LeakyReLU slope (reference D stack, BASELINE.json:5)
    dropout: float = 0.0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # "bfloat16" for TPU speed path


@dataclass(frozen=True)
class LossConfig:
    """Loss composition (reference layer L4)."""

    gan_loss: str = "lsgan"        # "ns" | "lsgan" | "hinge"
    recon_loss: str = "l1"         # "l1" | "mse" | "si_sdr" (wav domain)
    recon_domain: str = "spec"     # "spec" (log-magnitude) | "mag" (linear
    #                                magnitude) | "wav" (waveform through
    #                                the iSTFT VJP) | "cspec" (complex
    #                                re/im — phase-aware; REQUIRED for
    #                                complex masks to separate in the
    #                                waveform sense, since spec/mag leave
    #                                phase unsupervised).  Composite
    #                                domains join with "+" ("cspec+wav"):
    #                                the recon term is the weighted sum of
    #                                the per-domain losses; PIT matching
    #                                uses the FIRST domain listed.
    recon_domain_weights: Tuple[float, ...] = ()  # per-domain weights for a
    #                                composite recon_domain; () = all 1.0.
    #                                Length must match the number of "+"
    #                                components when set.
    recon_weight: float = 100.0
    adv_weight: float = 1.0
    use_pit: bool = True           # permutation-invariant matching (BASELINE.json:9)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8            # global batch (split over the data mesh axis)
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    g_lr_schedule: str = "constant"  # "constant" | "cosine" | "linear" decay
    d_lr_schedule: str = "constant"  # of the per-optimizer lr over
    #                                lr_decay_steps down to lr * lr_end_factor.
    #                                A D lr decay is a standard anti-saturation
    #                                tool (the hard-protocol rows measure
    #                                d_loss -> ~0 by 10k steps — D has won and
    #                                G's adversarial gradient vanishes).
    lr_decay_steps: int = 0        # schedule horizon (required > 0 when any
    #                                schedule is non-constant; the optimizer
    #                                step count, not wall-clock)
    lr_end_factor: float = 0.1     # final lr = base lr * this factor
    beta1: float = 0.5
    beta2: float = 0.999
    d_steps: int = 1               # D updates per G update (alternating schedule)
    r1_gamma: float = 0.0          # zero-centered R1 gradient penalty on D's
    #                                REAL inputs: + (gamma/2) E[||dD/dx||^2]
    #                                in the D loss (Mescheder et al. 2018).
    #                                Keeps a winning D's decision surface
    #                                flat around the data so its gradient to
    #                                G stays informative instead of
    #                                saturating.  0 disables.
    steps_per_dispatch: int = 1    # lax.scan this many optimizer steps per
    #                                jitted call (device-bank mode only) —
    #                                amortizes per-dispatch host/relay
    #                                overhead; logging/ckpt cadence rounds to
    #                                dispatch boundaries
    grad_clip: float = 5.0
    d_instance_noise: float = 0.0  # std of Gaussian added to EVERY D input
    #                                (real and fake pairs, and the G-side
    #                                adversarial D eval; log-magnitude
    #                                units).  Instance noise overlaps the
    #                                real/fake distributions so a winning D
    #                                cannot saturate (hard-protocol runs
    #                                measure d_loss -> ~2e-3, starving G of
    #                                adversarial signal).  0 disables.
    g_ema: float = 0.0             # EMA decay for a shadow copy of G params
    #                                (0 disables).  Standard GAN practice:
    #                                eval/inference use the averaged weights,
    #                                which smooth the G/D oscillation noise.
    total_steps: int = 100_000
    log_every: int = 50
    ckpt_every: int = 1000
    eval_every: int = 1000
    eval_batches: int = 8          # batches per in-loop evaluate() — this
    #                                metric drives keep_best selection, so it
    #                                must average enough eval sampling noise
    #                                (±0.3 dB bound noise at 4 batches was
    #                                comparable to real checkpoint deltas)
    keep_best: bool = True         # retain the checkpoint with the best
    #                                held-out eval SI-SDRi in workdir/best
    #                                (measured: the eval metric peaks well
    #                                before training ends — wsj0 easy +22.3
    #                                dB at 10k steps vs +19.8 at 50k; the
    #                                latest checkpoint is usually not the
    #                                one to deploy).  Auto-resume still
    #                                uses the latest.
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.g_ema < 1.0:
            raise ValueError(f"g_ema must be in [0, 1), got {self.g_ema}")
        for kind in (self.g_lr_schedule, self.d_lr_schedule):
            if kind not in ("constant", "cosine", "linear"):
                raise ValueError(
                    f"lr schedule must be constant/cosine/linear, got {kind!r}"
                )
            if kind != "constant" and self.lr_decay_steps <= 0:
                raise ValueError(
                    f"{kind!r} lr schedule needs lr_decay_steps > 0 "
                    "(the decay horizon in optimizer steps)"
                )
        if self.r1_gamma < 0.0:
            raise ValueError(f"r1_gamma must be >= 0, got {self.r1_gamma}")


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"     # "synthetic" | "wav_dir"
    data_dir: str = ""             # corpus root for "wav_dir"
    device_bank: bool = True       # upload the utterance bank to HBM once
    #                                and sample batches IN-GRAPH (no per-step
    #                                host->device transfer; BASELINE.json:5
    #                                "no host round-trips").  Falls back to
    #                                host batches when False.
    bank_utterances: int = 64      # bank entries per source slot
    num_sources: int = 2           # speakers mixed per example
    num_noise: int = 0             # additional noise sources
    segment_seconds: float = 2.0
    gain_jitter_db: float = 3.0    # random per-source gain for mixing
    snr_db: float = 10.0           # noise SNR when num_noise > 0
    f0_mode: str = "disjoint"      # synthetic speakers: "disjoint" = per-
    #                                slot f0 bands (easy; oracle-IRM nearly
    #                                reachable); "shared" = all slots draw
    #                                f0 from ONE overlapped range and differ
    #                                only by timbre/modulation — the hard
    #                                quality protocol (VERDICT r2 item 2:
    #                                keeps oracle headroom above training)
    eval_split: str = "eval"       # dataset split Experiment evaluates on:
    #                                "eval" = held-out latents/speakers
    #                                (generalization), "train" = the training
    #                                distribution (fit), "all" = no split —
    #                                A/B'ing these separates generalization
    #                                gaps from training regressions.
    slot_profiles: Tuple[str, ...] = ()  # per-slot synthetic signal class:
    #                                "harmonic" (default), "vocal" (vibrato
    #                                harmonic stack), "accomp" (chords +
    #                                broadband bed + transients) — the
    #                                music_complex_44k fixtures use
    #                                ("vocal", "accomp")

    def segment_samples(self, sample_rate: int, hop: int, n_fft: int) -> int:
        """Segment length in samples, snapped to the STFT frame grid so the
        frame count is exact (T = n_fft + k*hop for integer k ≥ 0)."""
        t = int(self.segment_seconds * sample_rate)
        if t < n_fft:
            return n_fft
        k = (t - n_fft) // hop
        return n_fft + k * hop


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh spec (SURVEY.md §2.3/§5.8): 1-D data-parallel over ICI,
    with an outer dcn axis (size 1 today) so multi-slice is config-only."""

    data_axis_size: int = -1       # -1 → all local devices
    dcn_axis_size: int = 1
    data_axis_name: str = "data"
    dcn_axis_name: str = "dcn"


@dataclass(frozen=True)
class StreamConfig:
    """Chunked streaming inference (BASELINE.json:11, SURVEY.md §5.7)."""

    chunk_seconds: float = 1.0
    overlap_frames: int = 4        # cross-fade overlap, in STFT hops
    batch_chunks: int = 8          # chunks batched per pjit dispatch
    perm_hysteresis: float = 0.0   # chunk-to-chunk permutation chaining:
    #                                only switch away from the previous
    #                                chunk's source assignment when the L2
    #                                improvement exceeds this fraction of
    #                                the stream loudness.  A NEAR-SILENT
    #                                overlap gives the matcher no evidence —
    #                                without the margin, noise-level L2
    #                                differences can flip sources mid-gap
    #                                (mechanism tests in tests/test_infer.py).
    #                                DEFAULT 0 (pure argmin) by MEASUREMENT:
    #                                on the end-to-end hard gap protocol
    #                                (scripts/stream_quality.py, BASELINE.md
    #                                round 5) a real separator flips its own
    #                                source->slot mapping per utterance;
    #                                per-chunk re-matching repairs those
    #                                flips (+1.56 dB, beats one-shot) while
    #                                a 1e-3 margin locks the stale
    #                                assignment across gaps (-2.3 dB batch /
    #                                -3.5 dB scan vs argmin).  An argmin
    #                                flip inside a silent gap is cheap and
    #                                self-corrects at the next loud overlap.


@dataclass(frozen=True)
class Config:
    name: str = "2src_toy_cpu"
    dsp: DSPConfig = field(default_factory=DSPConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)

    @property
    def segment_samples(self) -> int:
        return self.data.segment_samples(
            self.dsp.sample_rate, self.dsp.hop_length, self.dsp.n_fft
        )

    @property
    def num_frames(self) -> int:
        # tf.signal frame count; the DSP layer end-pads the signal by
        # n_fft - win_length so this holds for win_length < n_fft too.
        return 1 + (self.segment_samples - self.dsp.win_length) // self.dsp.hop_length

    # -- serialization (checkpoint fingerprinting, SURVEY.md §5.4) ---------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)

        def detuple(d):
            # JSON has no tuple: every sequence field (channel stacks,
            # strides, domain weights, ...) must come back as a tuple or
            # the frozen config loses hashability (jit-static contract).
            return {k: tuple(v) if isinstance(v, list) else v
                    for k, v in d.items()}

        return Config(
            name=raw["name"],
            dsp=DSPConfig(**detuple(raw["dsp"])),
            model=ModelConfig(**detuple(raw["model"])),
            loss=LossConfig(**detuple(raw["loss"])),
            train=TrainConfig(**detuple(raw["train"])),
            data=DataConfig(**detuple(raw["data"])),
            mesh=MeshConfig(**detuple(raw["mesh"])),
            stream=StreamConfig(**detuple(raw["stream"])),
        )

    def fingerprint(self) -> str:
        import hashlib

        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_CONFIGS: Dict[str, Callable[[], Config]] = {}


def register_config(name: str) -> Callable[[Callable[[], Config]], Callable[[], Config]]:
    def deco(fn: Callable[[], Config]) -> Callable[[], Config]:
        if name in _CONFIGS:
            raise ValueError(f"duplicate config name: {name}")
        _CONFIGS[name] = fn
        return fn

    return deco


def get_config(name: str, **overrides: Any) -> Config:
    """Fetch a preset by name; keyword overrides replace top-level sections
    (e.g. get_config('2src_toy_cpu', train=TrainConfig(batch_size=4)))."""
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_CONFIGS)}")
    cfg = _CONFIGS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_configs() -> Tuple[str, ...]:
    return tuple(sorted(_CONFIGS))


# ---------------------------------------------------------------------------
# The five contract presets (BASELINE.json:7-11)
# ---------------------------------------------------------------------------


@register_config("2src_toy_cpu")
def _toy() -> Config:
    """2-source magnitude-STFT mask G + small conv D, toy LibriSpeech-like
    mixtures, CPU-runnable (BASELINE.json:7)."""
    return Config(
        name="2src_toy_cpu",
        dsp=DSPConfig(sample_rate=8000, n_fft=256, hop_length=64,
                      win_length=256, feature="logmag", mask_type="magnitude"),
        model=ModelConfig(generator="conv", discriminator="conv",
                          g_channels=(16, 32), d_channels=(16, 32),
                          d_norm="spectral"),
        loss=LossConfig(use_pit=True),
        train=TrainConfig(batch_size=4, d_lr=1e-4),
        data=DataConfig(dataset="synthetic", num_sources=2,
                        segment_seconds=1.0),
    )


@register_config("wsj0_logmel")
def _wsj0() -> Config:
    """Log-mel frontend + deeper conv G/D on WSJ0-2mix-style mixtures
    (BASELINE.json:8)."""
    return Config(
        name="wsj0_logmel",
        dsp=DSPConfig(sample_rate=8000, n_fft=512, hop_length=128,
                      win_length=512, feature="logmel", n_mels=80,
                      mask_type="magnitude"),
        # bf16 compute (TPU speed path; masks/DSP/GAN logits stay f32 —
        # see models): +~2x step throughput at equal quality.
        # interp mask head: fixed mel-warp + 1x1 conv — position-free, so it
        # generalizes across pitch (measured held-out SI-SDRi +22.3 dB vs
        # +8.9 dB for the dense head at equal train-dist score; the dense
        # head memorizes trained f0 bin positions — BASELINE.md round 3).
        model=ModelConfig(generator="conv", discriminator="conv",
                          g_channels=(32, 64, 128), d_channels=(32, 64, 128),
                          compute_dtype="bfloat16", d_norm="spectral",
                          g_head_mode="interp"),
        # Linear-magnitude L1 (log-L1 scores the same on the toy benchmark;
        # see BASELINE.md quality table).
        loss=LossConfig(use_pit=True, recon_domain="mag"),
        train=TrainConfig(batch_size=16, d_lr=1e-4),
        # Synthetic by default so the preset runs as shipped (no corpora in
        # this env).  For a real WSJ0-style corpus:
        #   --set data.dataset=wav_dir --set data.data_dir=/path/to/speakers
        # (speaker subdirs of wavs; speaker-held-out eval split — corpus.py).
        data=DataConfig(dataset="synthetic", num_sources=2,
                        segment_seconds=3.0),
    )


@register_config("3src_pit")
def _3src() -> Config:
    """3-source separation, permutation-invariant adversarial + L1 loss
    (BASELINE.json:9)."""
    return Config(
        name="3src_pit",
        dsp=DSPConfig(sample_rate=8000, n_fft=512, hop_length=128,
                      win_length=512, feature="logmag", mask_type="magnitude",
                      mask_activation="softmax"),
        # film mask head: the Dense hidden->K head memorizes trained pitch
        # positions (held-out +8.8 vs train-dist +19.9 @5k); the film head
        # (bin-local dilated convs + FiLM from the BiLSTM state, fixed
        # sinusoidal freq encoding) scores +10.9 held-out easy / +2.6 hard
        # at equal train fit, ~2x step time (BASELINE.md round 3).
        # bf16 compute: +33% measured on the film-head step at equal
        # quality (easy +10.8 vs +10.9, hard +2.3 vs +2.6 — run noise);
        # masks still exit f32 from the head.
        model=ModelConfig(generator="bilstm", discriminator="conv",
                          g_hidden=300, g_layers=2,
                          d_channels=(32, 64, 128), d_norm="spectral",
                          g_head_mode="film", compute_dtype="bfloat16"),
        loss=LossConfig(use_pit=True, recon_loss="l1"),
        train=TrainConfig(batch_size=16, d_lr=1e-4),
        data=DataConfig(dataset="synthetic", num_sources=3,
                        segment_seconds=3.0),
    )


@register_config("music_complex_44k")
def _music() -> Config:
    """Music separation (vocals/accompaniment), complex-STFT masks at
    44.1 kHz (BASELINE.json:10)."""
    return Config(
        name="music_complex_44k",
        dsp=DSPConfig(sample_rate=44100, n_fft=2048, hop_length=512,
                      win_length=2048, feature="logmag", mask_type="complex"),
        # bf16 compute: +48% measured on this preset (G U-Net at the full
        # (257, 1025) grid dominates the step); complex masks still exit
        # f32 from the mask head.
        # g_channels (64,64,128,256): full-grid conv cost is channel-
        # INSENSITIVE up to C=64 on this geometry (16/32/64 ch all bench
        # 410-418 mix-s/s — the layout pads the channel axis), so the
        # wider level 0-1 is free and measures +0.9 dB held-out
        # (+16.2 vs +15.3 @10k; C=128 finally costs −28%).
        # d_stem_stride (4,8): +9.8% throughput (449.9 vs 409.7 mix-s/s)
        # at measured-equal held-out quality (+16.16 vs +16.2 @10k easy,
        # train-dist 16.93 vs 16.9) — the D stem at the (T, 1025) complex
        # pair grid was the remaining D-side hot spot.  The deeper combo
        # (+crop +seg 3.01 +b32) reaches 532 (+30%) but costs −0.8 dB
        # held-out (BASELINE.md subpixel section) so it stays opt-in.
        model=ModelConfig(generator="conv", discriminator="conv",
                          g_channels=(64, 64, 128, 256),
                          d_channels=(32, 64, 128, 256),
                          compute_dtype="bfloat16", d_norm="spectral",
                          d_stem_stride=(4, 8)),
        # Complex-spectrum (re, im) L1: the phase-aware domain — log-mag
        # recon left complex-mask phase unsupervised (measured -7 dB
        # SI-SDRi; with cspec the same toy task learns separation).
        loss=LossConfig(use_pit=False, recon_loss="l1",
                        recon_domain="cspec"),
        train=TrainConfig(batch_size=8, d_lr=1e-4),
        data=DataConfig(dataset="synthetic", num_sources=2,
                        segment_seconds=3.0,
                        slot_profiles=("vocal", "accomp")),
    )


@register_config("stream_v5e8")
def _stream() -> Config:
    """Streaming chunked overlap-add inference, batched pjit across a v5e-8
    data mesh (BASELINE.json:11)."""
    return Config(
        name="stream_v5e8",
        dsp=DSPConfig(sample_rate=16000, n_fft=512, hop_length=128,
                      win_length=512, feature="logmag", mask_type="magnitude"),
        # fold(1,2) G stem measured +43% throughput and +1.2 dB on the EASY
        # protocol but −2.9 dB held-out on the hard (noisy, shared-f0) one
        # (BASELINE.md r3) — fine per-bin detail matters once sources
        # overlap, so the default stays full-grid; fold is the documented
        # opt-in throughput lever (g_stem_mode="fold", g_stem_stride=(1,2)).
        # g_crop_nyquist: +26% throughput (644 vs 512 mix-s/s/chip) at
        # neutral quality (easy +17.1 vs +16.8; hard within the protocol's
        # ±1.3 dB seed variance: crop 9.1/8.5 vs no-crop 10.6/7.6 across
        # seeds 0/7) — the odd K=257 grid pads every full-grid tensor's
        # tiling at this batch-4 geometry.
        model=ModelConfig(generator="conv", discriminator="conv",
                          g_channels=(32, 64, 128), d_channels=(32, 64, 128),
                          compute_dtype="bfloat16", d_norm="spectral",
                          g_crop_nyquist=True),
        # Deployment preset: waveform −SI-SDR reconstruction measured best
        # (+21.9 dB SI-SDRi at 10k steps vs +19.7 for mag-/log-L1; see
        # BASELINE.md quality table).
        loss=LossConfig(use_pit=True, recon_domain="wav",
                        recon_loss="si_sdr", recon_weight=1.0),
        train=TrainConfig(batch_size=32, d_lr=1e-4),
        data=DataConfig(dataset="synthetic", num_sources=2,
                        segment_seconds=2.0),
        mesh=MeshConfig(data_axis_size=8),
        stream=StreamConfig(chunk_seconds=1.0, overlap_frames=4,
                            batch_chunks=8),
    )

"""The alternating G/D train step, the separation graph and the eval step.

Port of `gan_sass_tf_tpu/train/step.py` (`build_train_step`,
`build_separate_fn`, `build_eval_step`).  PyTorch runs eagerly, so the step
is a sequence of launches rather than one compiled program; its semantics
are the reference's:

  * sample the bank (or take the given sources) and mix;
  * the fused STFT-features kernel emits what the step needs for the
    mixture and the targets;
  * ONE G forward per step: `apply_mask` then |·| when the step needs the
    estimated spectrum (waveform or complex domains, complex masks), m·|X|
    otherwise;
  * PIT matching on a pooled bf16 grid, with no gradient;
  * the (real, fake) D input is built once, detached, and reused across
    `d_steps` D updates, each storing D's new spectral-norm state;
  * the G loss is taken against the just-updated D: D's parameters get no
    update from it, but its gradient flows through D to the estimate;
  * instance noise, R1, the EMA shadow of G and the lr schedules as the
    reference has them;
  * D is called in train mode, as the reference's `d_apply` calls it: a
    BN D normalizes with the statistics of the batch it is given (the
    real+fake pairs in a D update, the real half in R1, the fake pairs in
    the G loss) and stores running statistics from the D updates alone;
    `d_input_fold` folds f frames of the pairs into channels;
  * `g_remat` recomputes G's forward in the backward
    (`torch.utils.checkpoint`, the reference's `jax.checkpoint`);
  * the step's parts run in torch.profiler ranges named by
    `utils/profiler.STEP_RANGES` (`scripts/profile_step.py` buckets
    device time by them); they change no number;
  * data parallel (`dp`, the reference's `shard_map` over the mesh): each
    rank runs the step on its rows of the global batch and all-reduces
    (mean) D's gradients after each D step, G's gradients and the metrics,
    as the reference's `pmean`s; the optimizers clip the reduced
    gradients.  A BN D normalizes each rank's pairs with their own
    statistics and its running statistics are averaged over the ranks
    after the D steps, as the reference `pmean`s them; so with BN, R ranks
    do not compute what one rank does.  D's spectral-norm state is not
    reduced, where the reference `pmean`s it: its power iteration reads
    only D's weights and the stored u, which every rank holds equal, so
    every rank computes the same u and sigma.

Random numbers (bank picks, gains, noise) come from `data.counter_rng`,
keyed by (seed, step, global example), and not from the JAX package's
threefry streams.  Instance noise and dropout's keep-masks are keyed by
global example or pair row too, each call site its own stream, so R ranks
of B/R examples draw exactly the noise and masks of one rank of B (the
reference folds the shard index into its keys instead).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from gan_sass_tf_tpu_torch.data.counter_rng import counter_normal
from gan_sass_tf_tpu_torch.data.device_bank import sample_bank
from gan_sass_tf_tpu_torch.data.mixer import mix_sources
from gan_sass_tf_tpu_torch.dsp.masks import apply_mask
from gan_sass_tf_tpu_torch.models.dropout import DropoutKey
from gan_sass_tf_tpu_torch.losses import (
    align_to_perm,
    gan_d_loss,
    gan_g_loss,
    pit_si_sdr,
    pooled_match_perm,
    recon_loss,
    si_sdr,
)
from gan_sass_tf_tpu_torch.ops import dispatch as ops
from gan_sass_tf_tpu_torch.parallel.mesh import DataParallel
from gan_sass_tf_tpu_torch.train.state import TrainState

STREAM_D_NOISE, STREAM_G_NOISE = 31, 61   # + 2·d_step; each uses two streams
# Dropout: the G forward, the G loss's D call, and per D step (+ 32·d_step)
# its update and its R1 call; a module's dropout site i adds i.
STREAM_G_DROP, STREAM_G_ADV_DROP = 1000, 4000
STREAM_D_DROP, STREAM_R1_DROP = 2000, 3000


def instance_noise(x: torch.Tensor, std: float, seed: int, step: int,
                   stream: int, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + std·N(0, 1), the noise drawn per row of x from the counters (row
    i keyed by rows[i], default i) and rounded to x's dtype, as the
    reference adds it."""
    if std <= 0.0:
        return x
    if rows is None:
        rows = torch.arange(x.shape[0], device=x.device)
    noise = counter_normal(seed, step, rows, stream, x[0].numel())
    return x + std * noise.reshape(x.shape).to(x.dtype)


def build_train_step(cfg, from_bank: bool = False, local_batch: int = 0,
                     dp: Optional[DataParallel] = None
                     ) -> Callable[[TrainState, torch.Tensor, int],
                                   Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, data, seed) -> (state, metrics).  `data` is
    the (B, S, T) f32 sources of this rank or, with from_bank=True, the
    (S, N_bank, T) bank on the device, sampled for `local_batch` examples.
    With `dp` the rank's examples start at global index dp.rank·B_local.
    The state is updated in place and returned; the metrics are 0-d
    tensors on the device (reading them synchronizes)."""
    dp = dp or DataParallel()
    dcfg, lcfg, tcfg = cfg.dsp, cfg.loss, cfg.train
    n_fft, hop = dcfg.n_fft, dcfg.hop_length
    domains = tuple(lcfg.recon_domain.split("+"))
    for dn in domains:
        if dn not in ("spec", "mag", "wav", "cspec"):
            raise ValueError(f"unknown recon domain {dn!r} "
                             f"(in {lcfg.recon_domain!r})")
    dweights = lcfg.recon_domain_weights or (1.0,) * len(domains)
    if len(dweights) != len(domains):
        raise ValueError(
            f"recon_domain_weights has {len(dweights)} entries for "
            f"{len(domains)} domains in {lcfg.recon_domain!r}")
    need_est_spec = (any(dn in ("wav", "cspec") for dn in domains)
                     or dcfg.mask_type != "magnitude")
    mag_domain, cspec_domain = "mag" in domains, "cspec" in domains
    wav_domain = "wav" in domains
    mag_primary = domains[0] == "mag"          # PIT matches in the 1st domain
    spec_kind = "l1" if lcfg.recon_loss == "si_sdr" else lcfg.recon_loss
    d_dtype = getattr(torch, cfg.model.compute_dtype)
    d_noise, r1_gamma = float(tcfg.d_instance_noise), float(tcfg.r1_gamma)
    d_fold, g_remat = cfg.model.d_input_fold, cfg.model.g_remat
    mix_emit = (("spec",) if need_est_spec else ()) + ("mag", "logmag") \
        + (("logmel",) if dcfg.feature == "logmel" else ())
    tgt_emit = (("mag", "logmag") if mag_domain else ("logmag",)) \
        + (("spec",) if cspec_domain else ())

    def d_input(mix_logmag, cand_logmag):
        """(B, T, K) mixture + (B, S, T, K) candidates -> (B·S, T/f, K, 2f)
        pairs in the compute dtype, f = d_input_fold consecutive frames
        folded into channels (frame-major, as the reference), the frames
        past the last whole group of f dropped."""
        b, s = cand_logmag.shape[:2]
        mix_b = mix_logmag[:, None].expand_as(cand_logmag)
        x = torch.stack([mix_b.to(d_dtype), cand_logmag.to(d_dtype)], dim=-1)
        x = x.reshape(b * s, *x.shape[2:])               # (B·S, T, K, 2)
        if d_fold > 1:
            n, t, k, c = x.shape
            t2 = t // d_fold
            x = x[:, : t2 * d_fold].reshape(n, t2, d_fold, k, c).transpose(2, 3)
            x = x.reshape(n, t2, k, d_fold * c)
        return x

    def d_update(state: TrainState, x_d, rows, seed, step, di):
        """One D step on the detached pair batch (global pair rows `rows`):
        loss, grads averaged over the ranks, optimizer, and the new
        spectral-norm state stored."""
        d = state.d
        x = instance_noise(x_d, d_noise, seed, step, STREAM_D_NOISE + 2 * di, rows)
        loss = 0.0
        if r1_gamma > 0.0:
            # Zero-centred R1 on the real half, from the stored (pre-update)
            # spectral-norm state; the D gradient goes through the input
            # gradient (create_graph).
            half = x.shape[0] // 2
            x_real = x[:half].float().requires_grad_()
            lg = d(x_real.to(x.dtype), train=True, dropout=DropoutKey(
                seed, step, STREAM_R1_DROP + 32 * di, rows[:half]))
            (gx,) = torch.autograd.grad(lg.float().sum(), x_real, create_graph=True)
            loss = 0.5 * r1_gamma * gx.square().sum(dim=tuple(range(1, gx.dim()))).mean()
        real, fake = d(x, update_stats=True, train=True, dropout=DropoutKey(
            seed, step, STREAM_D_DROP + 32 * di, rows)).chunk(2)
        loss = gan_d_loss(real, fake, lcfg.gan_loss) + loss
        grads = torch.autograd.grad(loss, state.d_opt.params)
        dp.all_reduce_mean(grads)                 # before d_opt's clip
        with record_function("optimizer"):
            state.d_opt.step(grads)
        return loss.detach(), real.detach().mean(), fake.detach().mean()

    def train_step(state: TrainState, data: torch.Tensor, seed: int):
        step = state.step
        b = local_batch if from_bank else data.shape[0]
        offset = dp.rank * b                      # this rank's first global example
        with record_function("dsp"):
            sources = (sample_bank(data, seed, step, b, example_offset=offset)
                       if from_bank else data)
            mixture, scaled = mix_sources(sources, seed, step, cfg.data,
                                          example_offset=offset)
            mix_out = ops.stft_features(mixture, dcfg, emit=mix_emit)
            tgt_out = ops.stft_features(scaled, dcfg, emit=tgt_emit)
        spec_mix, mag_mix = mix_out.get("spec"), mix_out["mag"]
        mix_logmag = mix_out["logmag"]
        feats = mix_out["logmel"] if dcfg.feature == "logmel" else mix_logmag
        tgt_logmag, tgt_mag, tgt_spec = (tgt_out["logmag"], tgt_out.get("mag"),
                                         tgt_out.get("spec"))

        # The one G forward of the step (recomputed in the backward with
        # g_remat; the keyed dropout masks come out the same).
        g_key = DropoutKey(seed, step, STREAM_G_DROP,
                           offset + torch.arange(b, device=feats.device))

        def g_forward(f):
            return state.g(f, train=True, dropout=g_key)

        with record_function("g_fwd"):
            masks = (checkpoint(g_forward, feats, use_reentrant=False) if g_remat
                     else g_forward(feats))
            if need_est_spec:
                est_spec = apply_mask(spec_mix, masks, dcfg.mask_type)
                est_mag = est_spec.abs()
            else:      # magnitude masks: |m·X| = m·|X|, no complex product
                est_spec = None
                est_mag = masks * mag_mix[:, None]
            est_logmag = torch.log(est_mag + dcfg.eps)
        est_logmag_sg = est_logmag.detach()

        if lcfg.use_pit:
            with torch.no_grad(), record_function("pit"):
                match_kind = "l1" if lcfg.recon_loss == "si_sdr" else lcfg.recon_loss
                perm = pooled_match_perm(
                    est_mag.detach() if mag_primary else est_logmag_sg,
                    tgt_mag if mag_primary else tgt_logmag, match_kind)
                tgt_logmag = align_to_perm(tgt_logmag, perm)
                tgt_mag = align_to_perm(tgt_mag, perm) if mag_domain else None
                scaled = align_to_perm(scaled, perm) if wav_domain else scaled
                tgt_spec = align_to_perm(tgt_spec, perm) if cspec_domain else None

        with record_function("d_step"):
            # D updates on the pair batch built once, detached.
            x_d = torch.cat([d_input(mix_logmag, tgt_logmag),
                             d_input(mix_logmag, est_logmag_sg)])
            # Global pair rows: the real half's at offset·S + i, the fake
            # half's after all B·S real rows of the global batch.
            s = tgt_logmag.shape[1]
            real_rows = offset * s + torch.arange(b * s, device=x_d.device)
            fake_rows = dp.world * b * s + real_rows
            for di in range(tcfg.d_steps):
                d_loss, real_m, fake_m = d_update(
                    state, x_d, torch.cat([real_rows, fake_rows]), seed, step, di)
            # BN running statistics, from each rank's own pairs, averaged.
            dp.all_reduce_mean([t for n in state.d.norms if n.kind == "batch"
                                for t in (n.mean, n.var)])

        def domain_rec(dname):
            if dname == "wav":
                with record_function("dsp"):
                    est_r = ops.istft(est_spec, n_fft, hop, window=dcfg.window,
                                      win_length=dcfg.win_length)
                tgt_r = scaled[..., : est_r.shape[-1]]
                if lcfg.recon_loss == "si_sdr":
                    return -si_sdr(est_r, tgt_r).mean()
                return recon_loss(est_r, tgt_r, lcfg.recon_loss)
            if dname == "cspec":
                return recon_loss(torch.view_as_real(est_spec),
                                  torch.view_as_real(tgt_spec), spec_kind)
            if dname == "mag":
                return recon_loss(est_mag, tgt_mag, spec_kind)
            return recon_loss(est_logmag, tgt_logmag, spec_kind)

        with record_function("g_fwd"):
            rec = sum(w * domain_rec(dn) for w, dn in zip(dweights, domains))
            # Adversarial term against the just-updated D, fresh noise.
            fake_logits = state.d(
                instance_noise(d_input(mix_logmag, est_logmag), d_noise, seed,
                               step, STREAM_G_NOISE, real_rows),
                train=True, dropout=DropoutKey(seed, step, STREAM_G_ADV_DROP, real_rows))
            adv = gan_g_loss(fake_logits, lcfg.gan_loss)
            g_loss = lcfg.adv_weight * adv + lcfg.recon_weight * rec
        with record_function("g_bwd"):
            g_grads = torch.autograd.grad(g_loss, state.g_opt.params)
            dp.all_reduce_mean(g_grads)           # before g_opt's clip
        with record_function("optimizer"):
            state.g_opt.step(g_grads)
            if state.g_ema is not None:
                # Warm-up ramp min(decay, (1+t)/(10+t)), t the post-update count.
                t = float(step + 1)
                decay = min(tcfg.g_ema, (1.0 + t) / (10.0 + t))
                with torch.no_grad():
                    for name, p in state.g.named_parameters():
                        e = state.g_ema[name]
                        e.copy_(e * decay + p * (1.0 - decay))
        state.step = step + 1
        metrics = {"d_loss": d_loss, "g_loss": g_loss.detach(),
                   "g_adv": adv.detach(), "g_recon": rec.detach(),
                   "d_real_logit": real_m, "d_fake_logit": fake_m}
        dp.all_reduce_mean(list(metrics.values()))
        return state, metrics

    return train_step


def build_separate_fn(cfg, g: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """separate(mixture (B, T)) -> (B, S, T) wavs: two DSP kernels around G.
    The separated complex spectra never reach device memory."""
    dcfg = cfg.dsp
    feat_key = "logmel" if dcfg.feature == "logmel" else "logmag"

    @torch.inference_mode()
    def separate(mixture: torch.Tensor) -> torch.Tensor:
        out = ops.stft_features(mixture, dcfg, emit=("spec", feat_key))
        masks = g(out[feat_key])
        wavs = ops.masked_istft(
            out["spec"], masks, dcfg.n_fft, dcfg.hop_length,
            window=dcfg.window, mask_type=dcfg.mask_type,
            win_length=dcfg.win_length,
        )
        # Length-stable output: with win_length < n_fft the tf-exact iSTFT
        # is n_fft - win_length samples short; pad with (honest) zeros.
        t = mixture.shape[-1]
        if wavs.shape[-1] < t:
            wavs = F.pad(wavs, (0, t - wavs.shape[-1]))
        return wavs[..., :t]

    return separate


def build_eval_step(cfg, g: torch.nn.Module, dp: Optional[DataParallel] = None
                    ) -> Callable[[torch.Tensor, int], Dict[str, torch.Tensor]]:
    """eval_step(sources (B, S, T), seed) -> best-permutation SI-SDR of the
    separated estimates, the mixture's own, and the improvement (batch
    means, 0-d tensors).  With `dp`, `sources` are this rank's rows of the
    global batch and the means are taken over all ranks."""
    separate = build_separate_fn(cfg, g)
    dp = dp or DataParallel()

    @torch.inference_mode()
    def eval_step(sources: torch.Tensor, seed: int) -> Dict[str, torch.Tensor]:
        mixture, scaled = mix_sources(sources, seed, 0, cfg.data,
                                      example_offset=dp.rank * sources.shape[0])
        est = separate(mixture)
        t = est.shape[-1]
        tgt = scaled[..., :t]
        sisdr = pit_si_sdr(est, tgt).mean()
        baseline = pit_si_sdr(mixture[:, None, :t].expand_as(tgt), tgt).mean()
        out = {"si_sdr": sisdr, "si_sdr_mix": baseline,
               "si_sdr_improvement": sisdr - baseline}
        dp.all_reduce_mean(list(out.values()))
        return out

    return eval_step

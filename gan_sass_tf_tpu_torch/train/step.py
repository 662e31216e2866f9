"""The alternating G/D train step, the separation graph and the eval step.

Port of `gan_sass_tf_tpu/train/step.py` (`build_train_step`,
`build_separate_fn`, `build_eval_step`).  PyTorch runs eagerly, so the step
is a sequence of launches rather than one compiled program (on the card,
`train/graphed.py` captures that sequence once as a CUDA graph, and
`eval_fn_for` the eval step's); its semantics are the reference's:

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

Random numbers: every draw is the JAX step's, from its keys (threefry,
`ops/threefry.py`).  The bank picks and shifts, the gains and the noise:
the train key folded with the step number, split in 5, rng_data and
rng_mix folded with each global example and split again
(`gan_sass_tf_tpu/train/step.py:213-214`).  Dropout's keep-masks and D's
instance noise, when either is on: rng_g, rng_dl and rng_ga (entries 2-4
of that split) folded with the rank's shard index, rng_dl folded with each
D step and split in 3, rng_ga split in 2 (`:215-228`, `:317`, `:178`,
`:372`).  On the card one launch derives all of those keys and assembles
the batch (rows, shifts, gains, mixture; a second launch adds the noise:
`ops.dispatch.step_batch`); each module call draws its masks under
flax's `make_rng` keys (`models/dropout.py`), the noise under its own
key, one fused launch each.  So R ranks draw what JAX's shard_map step
draws at R shards.  The key is a (2,) int64 tensor on the device and the
step number is `state.step`, a 0-d tensor on the device that the step
reads there and advances in place; the lr schedules, the bias corrections
and the EMA decay are computed from it on the device.  So a step reads no
number on the host, and `train/graphed.py` captures it once as a CUDA
graph and replays it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from gan_sass_tf_tpu_torch.data.mixer import mix_sources, noise_snr
from gan_sass_tf_tpu_torch.data.threefry import prng_key
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
from gan_sass_tf_tpu_torch.ops.threefry import train_key_rows
from gan_sass_tf_tpu_torch.parallel.mesh import DataParallel
from gan_sass_tf_tpu_torch.train.graphed import GeneratorMemo, GraphedFn
from gan_sass_tf_tpu_torch.train.state import TrainState

def instance_noise(x: torch.Tensor, std: float, key: torch.Tensor) -> torch.Tensor:
    """x + std·N(0, 1) drawn under the threefry `key` for x in the flax
    layout, in x's dtype, as the reference adds it (x itself at std 0)."""
    if std <= 0.0:
        return x
    return ops.instance_noise(x, key, std)


def build_train_step(cfg, from_bank: bool = False, local_batch: int = 0,
                     dp: Optional[DataParallel] = None
                     ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                   Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, data, key) -> (state, metrics).  `data` is
    the (B, S, T) f32 sources of this rank or, with from_bank=True, the
    (S, N_bank, T) bank on the device, sampled for `local_batch` examples;
    `key` is the train key, a (2,) int64 threefry key on the device (the
    JAX step's `rng`; `data.prng_key(seed)`).  With `dp` the rank's
    examples start at global index dp.rank·B_local, and its dropout and
    noise keys fold in dp.rank, the reference's shard index.  The state is
    updated in place (`state.step` advanced by one) and returned; the
    metrics are 0-d tensors on the device (reading them synchronizes)."""
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

    def d_update(state: TrainState, x_d, keys):
        """One D step on the detached pair batch: loss, grads averaged over
        the ranks, optimizer, and the new spectral-norm state stored.
        `keys` are the D step's (dropout, noise, R1 dropout) keys (Nones
        when neither dropout nor noise is on)."""
        d = state.d
        drop_key, noise_key, r1_key = keys
        x = instance_noise(x_d, d_noise, noise_key)
        loss = 0.0
        if r1_gamma > 0.0:
            # Zero-centred R1 on the real half, from the stored (pre-update)
            # spectral-norm state; the D gradient goes through the input
            # gradient (create_graph).
            half = x.shape[0] // 2
            x_real = x[:half].float().requires_grad_()
            lg = d(x_real.to(x.dtype), train=True, dropout=dropout_key(r1_key))
            (gx,) = torch.autograd.grad(lg.float().sum(), x_real, create_graph=True)
            loss = 0.5 * r1_gamma * gx.square().sum(dim=tuple(range(1, gx.dim()))).mean()
        real, fake = d(x, update_stats=True, train=True,
                       dropout=dropout_key(drop_key)).chunk(2)
        loss = gan_d_loss(real, fake, lcfg.gan_loss) + loss
        grads = torch.autograd.grad(loss, state.d_opt.params)
        dp.all_reduce_mean(grads)                 # before d_opt's clip
        with record_function("optimizer"):
            state.d_opt.step(grads)
        return loss.detach(), real.detach().mean(), fake.detach().mean()

    step_draws = d_noise > 0.0 or cfg.model.dropout > 0.0
    snr_db = noise_snr(cfg.data)
    g_row, d_rows, adv_rows = train_key_rows(tcfg.d_steps)

    def dropout_key(key):
        return None if key is None else DropoutKey(key)

    def train_step(state: TrainState, data: torch.Tensor, key):
        step = state.step.clone()        # this step's number, whatever moves it
        b = local_batch if from_bank else data.shape[0]
        offset = dp.rank * b                      # this rank's first global example
        with record_function("dsp"):
            # The batch, and dropout's and instance noise's keys with the
            # shard folded in.
            batch = ops.step_batch(key, data, cfg.data.gain_jitter_db, snr_db,
                                   offset=offset, step=step,
                                   bank_batch=b if from_bank else 0, shard=dp.rank,
                                   d_steps=tcfg.d_steps if step_draws else 0)
            mixture, scaled, rk = batch.mixture, batch.scaled, batch.train_keys

            def key_at(row):
                return None if rk is None else rk[row]
            mix_out = ops.stft_features(mixture, dcfg, emit=mix_emit)
            tgt_out = ops.stft_features(scaled, dcfg, emit=tgt_emit)
        spec_mix, mag_mix = mix_out.get("spec"), mix_out["mag"]
        mix_logmag = mix_out["logmag"]
        feats = mix_out["logmel"] if dcfg.feature == "logmel" else mix_logmag
        tgt_logmag, tgt_mag, tgt_spec = (tgt_out["logmag"], tgt_out.get("mag"),
                                         tgt_out.get("spec"))

        # The one G forward of the step (recomputed in the backward with
        # g_remat; the keyed dropout masks come out the same).
        g_key = dropout_key(key_at(g_row))

        def g_forward(f):
            return state.g(f, train=True, dropout=g_key)

        with record_function("g_fwd"):
            # G draws no torch random number (its dropout is keyed), so
            # the recompute needs no saved RNG state.
            masks = (checkpoint(g_forward, feats, use_reentrant=False,
                                preserve_rng_state=False) if g_remat
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
            for di in range(tcfg.d_steps):
                d_loss, real_m, fake_m = d_update(
                    state, x_d, [key_at(r) for r in d_rows[di]])
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
            adv_drop, adv_noise = (key_at(r) for r in adv_rows)
            fake_logits = state.d(
                instance_noise(d_input(mix_logmag, est_logmag), d_noise, adv_noise),
                train=True, dropout=dropout_key(adv_drop))
            adv = gan_g_loss(fake_logits, lcfg.gan_loss)
            g_loss = lcfg.adv_weight * adv + lcfg.recon_weight * rec
        with record_function("g_bwd"):
            g_grads = torch.autograd.grad(g_loss, state.g_opt.params)
            dp.all_reduce_mean(g_grads)           # before g_opt's clip
        with record_function("optimizer"):
            state.g_opt.step(g_grads)
            if state.g_ema is not None:
                # Warm-up ramp min(decay, (1+t)/(10+t)), t the post-update
                # count, in float32 as the reference.
                t = (step + 1).float()
                decay = ((1.0 + t) / (10.0 + t)).clamp(max=tcfg.g_ema)
                keep = 1.0 - decay
                with torch.no_grad():
                    for name, p in state.g.named_parameters():
                        e = state.g_ema[name]
                        e.copy_(e * decay + p * keep)
        state.step.add_(1)
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


def build_eval_scores(cfg, g: torch.nn.Module, rank: int = 0
                      ) -> Callable[[torch.Tensor, Union[int, torch.Tensor]],
                                    Dict[str, torch.Tensor]]:
    """scores(sources (B, S, T), seed) -> this rank's batch means of the
    best-permutation SI-SDR of the separated estimates, the mixture's own,
    and the improvement (0-d tensors); the mixtures drawn under
    PRNGKey(seed) for global examples rank·B + [0, B), as the JAX eval step
    under the key it is given.  `seed` is an int or a 0-d int64 tensor on
    the sources' device (what a captured eval reads)."""
    separate = build_separate_fn(cfg, g)

    @torch.inference_mode()
    def scores(sources: torch.Tensor, seed) -> Dict[str, torch.Tensor]:
        mixture, scaled = mix_sources(sources, prng_key(seed, sources.device), cfg.data,
                                      example_offset=rank * sources.shape[0])
        est = separate(mixture)
        t = est.shape[-1]
        tgt = scaled[..., :t]
        sisdr = pit_si_sdr(est, tgt).mean()
        baseline = pit_si_sdr(mixture[:, None, :t].expand_as(tgt), tgt).mean()
        return {"si_sdr": sisdr, "si_sdr_mix": baseline,
                "si_sdr_improvement": sisdr - baseline}

    return scores


def build_eval_step(cfg, g: torch.nn.Module, dp: Optional[DataParallel] = None
                    ) -> Callable[[torch.Tensor, Union[int, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """eval_step(sources (B, S, T), seed) -> `build_eval_scores`' means,
    eagerly.  With `dp`, `sources` are this rank's rows of the global batch
    and the means are taken over all ranks."""
    dp = dp or DataParallel()
    scores = build_eval_scores(cfg, g, dp.rank)

    @torch.inference_mode()
    def eval_step(sources: torch.Tensor, seed) -> Dict[str, torch.Tensor]:
        out = scores(sources, seed)
        dp.all_reduce_mean(list(out.values()))
        return out

    return eval_step


@GeneratorMemo
def eval_fn_for(cfg, g: torch.nn.Module, dp: Optional[DataParallel] = None) -> GraphedFn:
    """`build_eval_step(cfg, g, dp)` memoised per (cfg, G, dp) with G held
    weakly, and on CUDA captured per sources shape (after WARMUP_CALLS
    eager calls) and replayed (`GraphedFn`), its seed a 0-d int64 device
    tensor: the counterpart of the JAX `Experiment._eval_step`'s jit.  The
    mixing draws, G, K1, K2, the PIT SI-SDR and, over a process group, the
    all-reduce of the means are in the graph, as the reference's `pmean`
    is in its jitted `shard_map`.  `dp`, its process group with it, is
    part of the key: a new group gets a graph of its own."""
    return GraphedFn(build_eval_step(cfg, g, dp))

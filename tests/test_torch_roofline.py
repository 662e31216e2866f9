"""The port's bytes ledger and roofline (`scripts/bytes_ledger.py`,
`scripts/roofline.py`) and the kernels' cost module (`ops/cost.py`), on the
CPU at narrow widths: the FLOP count of one f32 step against the JAX
package's compiled step (`cost_analysis()["flops"]`), the LSTM's rule
against the gate matmuls torch.lstm decomposes into, the bytes rules, the
attribution by the step's ranges, each kernel charged from its cost, the
roofline's JSON line, and the cost module against PERF.md's bound column.
Each JAX step is compiled once (a module-scoped fixture)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import test_torch_train as ttt
from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset
from gan_sass_tf_tpu.train.state import create_train_state as j_create_train_state
from gan_sass_tf_tpu.train.step import build_train_step as j_build_train_step
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.data import prng_key
from gan_sass_tf_tpu_torch.data.threefry import split
from gan_sass_tf_tpu_torch.ops import cost, dispatch
from gan_sass_tf_tpu_torch.scripts import bytes_ledger as bl
from gan_sass_tf_tpu_torch.scripts import roofline
from gan_sass_tf_tpu_torch.train import Experiment, build_train_step
from gan_sass_tf_tpu_torch.train.state import create_train_state
from gan_sass_tf_tpu_torch.utils.profiler import STEP_RANGES

# The narrow presets of tests/test_torch_train.py.
NARROW_CFGS = {"wsj0_logmel": ttt._wsj0_cfg, "stream_v5e8": lambda: ttt._cfg("wav")}
FLOP_TOL = 0.05


def _seconds(cfg, seconds):
    return cfg.replace(data=dataclasses.replace(cfg.data, segment_seconds=seconds))


# The FLOPs are held at those presets, wsj0_logmel's at 0.5 s (its 8 kHz
# 0.25 s segment is 12 frames: XLA's count leaves out the convolution taps
# that fall on padding, which at 12 frames puts it 4.6 % under the port's).
FLOP_CFGS = {"wsj0_logmel": lambda: _seconds(ttt._wsj0_cfg(), 0.5),
             "stream_v5e8": lambda: ttt._cfg("wav")}


def _sections(cfg) -> dict:
    """A config's JSON without its mesh (the ledger's configs span every
    device)."""
    d = json.loads(cfg.to_json())
    d.pop("mesh")
    return d


@pytest.mark.parametrize("preset", sorted(NARROW_CFGS))
def test_narrow_overrides_are_the_train_tests_configs(preset):
    """bytes_ledger.NARROW (what chip_smoke.py counts on the CPU and the
    card) is test_torch_train.py's narrow configuration of the preset."""
    ours = bl.experiment_config(preset, None, bl.NARROW[preset])
    assert _sections(ours) == _sections(NARROW_CFGS[preset]())


@pytest.fixture(scope="module")
def flop_counts():
    """{preset: (the port's ledger of one f32 step, the JAX compiled step's
    cost_analysis flops, XLA's flops of the step's rFFTs)} at the narrow
    presets, on the same sources."""
    out = {}
    for preset, make in FLOP_CFGS.items():
        cfg = make()
        jcfg = j_config.Config.from_json(cfg.to_json())
        g, d = jmodels.build_generator(jcfg), jmodels.build_discriminator(jcfg)
        jstate = j_create_train_state(jcfg, g, d, jax.random.PRNGKey(0))
        src = SyntheticDataset(jcfg, seed=3).batch()
        compiled = jax.jit(j_build_train_step(jcfg, g, d)).lower(
            jstate, jnp.asarray(src), jax.random.PRNGKey(7)).compile()
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        n_fft, hop = cfg.dsp.n_fft, cfg.dsp.hop_length
        frames = cost.frames(src.shape[-1], n_fft, hop)
        rows = src.shape[0] * (1 + src.shape[1])         # mixtures and targets
        fft = jax.jit(jnp.fft.rfft).lower(
            jnp.zeros((rows, frames, n_fft), jnp.float32)).compile().cost_analysis()
        fft = fft[0] if isinstance(fft, (list, tuple)) else fft
        state, step = create_train_state(cfg, "cpu", 0), build_train_step(cfg)
        ledger, _ = bl.count(step, state, torch.from_numpy(src), prng_key(7))
        out[preset] = (ledger, float(ca["flops"]), float(fft.get("flops", 0.0)))
    return out


@pytest.mark.parametrize("preset", sorted(FLOP_CFGS))
def test_step_flops_match_jax_cost_analysis(flop_counts, preset):
    """One narrow f32 step: the port's count (convolutions, their backward,
    matmuls, and the kernels' analytic FFTs) within 5 % of XLA's count of the
    compiled JAX step, which also counts elementwise work."""
    ledger, jax_flops, fft_flops = flop_counts[preset]
    ours = ledger.total_flops()
    print(f"{preset}: port {ours / 1e6:.2f} MFLOP (kernels "
          f"{ledger.kernel_flops() / 1e6:.2f}), JAX {jax_flops / 1e6:.2f} MFLOP "
          f"(XLA charges the step's rFFTs {fft_flops / 1e6:.2f})")
    assert ledger.kernel_flops() > 0
    assert abs(ours - jax_flops) <= FLOP_TOL * jax_flops, (ours, jax_flops)


def _pit3_cfg():
    """3src_pit at tests/test_torch_pit3.py's narrow geometry."""
    cfg = config.get_config("3src_pit")
    return cfg.replace(
        dsp=dataclasses.replace(cfg.dsp, n_fft=64, hop_length=16, win_length=64),
        model=dataclasses.replace(cfg.model, g_hidden=16, g_film_channels=8,
                                  d_channels=(8, 16), compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=2, d_instance_noise=0.0),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25, gain_jitter_db=0.0,
                                 num_noise=0, bank_utterances=4))


def test_lstm_rule_equals_its_decomposed_gate_matmuls():
    """A narrow 3src_pit step: the rule's charge of each torch.lstm call
    (forward and backward) is what the dispatcher counts from the gate
    matmuls torch.lstm decomposes into on the CPU with oneDNN off, so the
    two counts of the step are equal."""
    exp = Experiment(_pit3_cfg(), workdir=None, device="cpu")
    ruled = bl.step_ledger(exp)
    with torch.backends.mkldnn.flags(enabled=False):
        plain, _ = bl.count(exp._train_step, exp.state, exp._bank, exp._train_key,
                            lstm_rule=False)
    lstm = {op: f for (r, op), f in ruled.op_flops.items() if op.startswith("lstm")}
    gates = sum(f for (r, op), f in plain.op_flops.items()
                if r in ("g_fwd", "g_bwd") and op in ("aten.mm", "aten.addmm"))
    assert sum(lstm.values()) > 0 and gates > 0
    assert ruled.total_flops() == plain.total_flops()
    assert not any(op.startswith("lstm") for _, op in plain.op_flops)


def test_lstm_flops_rule_on_a_call():
    """The rule at one bidirectional call whose input needs no gradient (G's
    first layer): forward 2·(2BTI·4H + 2BTH·4H), backward each direction's
    input weight 2BTI·4H, recurrent weight T·2BH·4H and carry (T-1)·2B·4H·H."""
    b, t, i, h = 2, 5, 6, 4
    x, z = torch.zeros(b, t, i), torch.zeros(2, b, h)
    ws = [torch.zeros(4 * h, i, requires_grad=True), torch.zeros(4 * h, h, requires_grad=True),
          torch.zeros(4 * h), torch.zeros(4 * h, requires_grad=True)] * 2
    fwd, bwd = bl.lstm_flops(x, (z, z), ws, True, 1, True, True)
    g = 4 * h
    assert fwd == 2 * (2 * b * t * i * g + 2 * b * t * h * g)
    assert bwd == 2 * (2 * b * t * i * g + t * 2 * b * h * g + (t - 1) * 2 * b * g * h)


# -- the bytes rules ---------------------------------------------------------

def _bytes(fn) -> float:
    ledger, _ = bl.count(fn)
    return ledger.total_bytes()


def test_views_are_free():
    x, m = torch.zeros(4, 5, 6), torch.zeros(4, 5)
    for fn in (lambda: x.view(20, 6), lambda: m.t(), lambda: x.permute(2, 0, 1),
               lambda: x.detach(), lambda: x[:, None].expand(4, 3, 5, 6),
               lambda: x[1:3], lambda: x.unsqueeze(0), lambda: x.reshape(120)):
        assert _bytes(fn) == 0


def test_copies_casts_and_in_place_ops():
    """`contiguous` of a permuted tensor and a cast charge a read and a
    write; an in-place add its written operand once beside the other; a
    copy_ a read and a write; an expanded operand its stored elements."""
    x, y = torch.zeros(4, 5, 6), torch.ones(4, 5, 6)
    n = x.numel()
    assert _bytes(lambda: x.permute(2, 0, 1).contiguous()) == 2 * 4 * n
    assert _bytes(lambda: x.to(torch.bfloat16)) == 4 * n + 2 * n
    assert _bytes(lambda: x.add_(y)) == 2 * 4 * n
    assert _bytes(lambda: x.copy_(y)) == 2 * 4 * n
    row = torch.ones(6)
    assert _bytes(lambda: x + row.expand(4, 5, 6)) == 4 * n + 4 * 6 + 4 * n


def test_convolution_charged_input_weight_output():
    x, w = torch.randn(1, 2, 5, 5), torch.randn(3, 2, 3, 3)
    ledger, out = bl.count(lambda: F.conv2d(x, w))
    assert ledger.total_bytes() == 4 * (x.numel() + w.numel() + out.numel())
    assert ledger.total_flops() == 2 * out.numel() * 2 * 3 * 3


# -- attribution -------------------------------------------------------------

def test_every_op_of_a_step_lands_in_one_range(flop_counts):
    """Ops of a step (backward ones included) fall in STEP_RANGES or
    "other", the ranges sum to the total, and the parts sit where the step
    runs them: G's and D's convolution backwards in g_bwd and d_step, K1
    and K3 with its adjoint in dsp; outside the ranges only bookkeeping."""
    ledger, _, _ = flop_counts["stream_v5e8"]
    assert set(ledger.bytes) <= set(STEP_RANGES) | {bl.OTHER}
    assert sum(ledger.bytes.values()) == ledger.total_bytes() == sum(ledger.op_bytes.values())
    assert sum(ledger.flops.values()) == sum(ledger.op_flops.values())
    ops = {r: {op for (rr, op) in ledger.op_bytes if rr == r} for r in ledger.bytes}
    assert "aten.convolution_backward" in ops["g_bwd"] & ops["d_step"]
    assert "aten.convolution" in ops["g_fwd"] & ops["d_step"]
    assert {"kernel stft_features", "kernel istft", "kernel istft_bwd",
            "kernel threefry_batch"} <= ops["dsp"]
    assert any(op.startswith("aten._foreach") for op in ops["optimizer"])
    assert ledger.bytes[bl.OTHER] < 1e-3 * ledger.total_bytes()


# -- the hand-written kernels ------------------------------------------------

def test_stft_features_charged_its_cost_whatever_its_plain_path_does():
    dcfg = config.get_config("wsj0_logmel").dsp
    x = torch.randn(3, 2000)
    emit = ("mag", "logmag", "logmel")
    ledger, out = bl.count(lambda: dispatch.stft_features(x, dcfg, emit=emit))
    want = cost.stft_features(3, 2000, dcfg.n_fft, dcfg.hop_length, emit, dcfg.n_mels)
    assert out["logmel"].shape[-1] == dcfg.n_mels
    assert ledger.launches() == {"stft_features": 1}
    assert (ledger.total_bytes(), ledger.total_flops()) == (want.bytes, want.flops)


def test_istft_and_its_adjoint_charged_once_each_in_dsp():
    spec = torch.randn(3, 12, 257, dtype=torch.complex64, requires_grad=True)
    dy = torch.randn(3, 11 * 128 + 512)

    def fwd_bwd():
        return torch.autograd.grad(dispatch.istft(spec, 512, 128), spec, dy)

    ledger, (g,) = bl.count(fwd_bwd)
    assert g.shape == spec.shape
    assert ledger.launches() == {"istft": 1, "istft_bwd": 1}
    want = cost.istft(3, 12, 512, 128) + cost.istft_adjoint(3, 12, 512, 128)
    assert (ledger.total_bytes(), ledger.total_flops()) == (want.bytes, want.flops)
    assert set(ledger.bytes) == {"other", "dsp"}
    assert ledger.bytes["dsp"] == cost.istft_adjoint(3, 12, 512, 128).bytes


def test_dropout_charged_forward_backward_and_double_backward():
    """Dropout's forward, backward and R1's double backward each charged one
    launch of its cost; the plain ops inside counted no more; the result
    the plain path's."""
    x = torch.randn(2, 3, 4, 5, requires_grad=True)
    dy = torch.randn(2, 3, 4, 5, requires_grad=True)
    key, c = prng_key(3), cost.dropout(x.numel(), 4)
    cm = cost.dropout_mask(x.numel(), 4)

    def run():
        y = dispatch.dropout(x, key, 7, 0.5, (0, 3, 1, 2))
        (gx,) = torch.autograd.grad(y, x, dy, create_graph=True)
        (gdy,) = torch.autograd.grad(gx, dy, torch.ones_like(gx))
        return y, gx, gdy

    ledger, (y, gx, gdy) = bl.count(run)
    y_ref = dispatch.dropout(x, key, 7, 0.5, (0, 3, 1, 2))
    assert torch.equal(y, y_ref) and torch.equal(gx, torch.where(y_ref != 0, 2 * dy, 0))
    assert ledger.launches() == {"threefry_dropout": 1, "threefry_dropout_bwd": 2}
    assert ledger.kernel_bytes() == c.bytes + 2 * cm.bytes
    assert ledger.kernels["threefry_dropout_bwd"]["int_ops"] == 0
    ones = 4 * x.numel()                       # the ones_like written
    assert ledger.total_bytes() == c.bytes + 2 * cm.bytes + ones


def test_draws_charged_from_their_shapes():
    """A step's batch charged one launch of the batch kernel and, under
    noise, one of its noise pass, at one tile a row as at two; the sampler
    a launch a draw; the plain ops inside counted no more."""
    key, step = prng_key(5), torch.tensor(3)
    bank, keys = torch.randn(2, 6, 1500), split(key, 4)

    def run():
        return (dispatch.step_batch(key, bank, 3.0, 10.0, step=step, bank_batch=4,
                                    d_steps=2),
                dispatch.step_batch(key, bank[:, :3, :900].transpose(0, 1), 3.0, 10.0),
                dispatch.draw(keys, 7, "randint", 0, 9),
                dispatch.draw(keys, 11, "normal"))

    ledger, _ = bl.count(run)
    assert ledger.launches() == {"threefry_batch": 2, "threefry_batch_noise": 2,
                                 "threefry_sample": 2}
    want = (cost.batch(4, 2, 1500, 2, True, True, True, 2) + cost.batch_noise(4, 1500, 2)
            + cost.batch(3, 2, 900, 1, False, False, True) + cost.batch_noise(3, 900, 1)
            + cost.sample(4, 7, "randint")
            + cost.sample(4, 11, "normal"))
    assert ledger.kernel_bytes() == want.bytes
    assert sum(r["int_ops"] for r in ledger.kernels.values()) == want.int_ops


def test_randint_charges_two_ciphers_a_value_and_two_a_row():
    """A randint draws two bit arrays (a cipher a value each) under its key's
    two splits (two ciphers a row); the other kinds a cipher a value."""
    for rows, n in ((1, 1), (128, 2), (32, 32000)):
        assert cost.sample(rows, n, "randint").int_ops \
            == cost.CIPHER_INT_OPS * (2 * n + 2) * rows
        for kind in ("bits", "uniform", "normal"):
            assert cost.sample(rows, n, kind).int_ops == cost.CIPHER_INT_OPS * n * rows
    assert cost.sample(128, 2, "randint").bytes == 16 * 128 + 8 * 128 * 2


# -- the roofline's line -------------------------------------------------------

ROOFLINE_KEYS = {
    "preset", "batch", "device", "ms_per_step", "eager_ms_per_step", "mix_s_per_s",
    "hlo_gflops_per_step", "hlo_gb_per_step", "hlo_logical_gb_per_step",
    "cost_analysis_gb_per_step", "kernel_gflops_per_step", "kernel_gb_per_step",
    "achieved_tflops", "achieved_gbs", "tc_util_vs_peak", "hbm_util_vs_peak",
    "peak_tflops", "peak", "bound", "speed_of_light_ms", "sol_headroom_x",
    "dsp_backend", "gpu", "kernel_launches"}


def test_roofline_cpu_line_keeps_its_contract(capsys):
    """--device cpu on 2src_toy_cpu: one JSON line with the documented keys,
    the counts, the wall ms, the TF32 peak named, and null shares."""
    assert roofline.main(["2src_toy_cpu", "--device", "cpu", "--steps", "1",
                          "--batch", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == ROOFLINE_KEYS
    assert line["preset"] == "2src_toy_cpu" and line["batch"] == 1
    assert line["peak_tflops"] == 495.0 and "TF32" in line["peak"]
    assert line["hlo_gflops_per_step"] > line["kernel_gflops_per_step"] > 0
    assert line["hlo_gb_per_step"] == line["cost_analysis_gb_per_step"] > 0
    assert line["ms_per_step"] > 0 and line["speed_of_light_ms"] > 0
    for key in ("achieved_tflops", "achieved_gbs", "tc_util_vs_peak",
                "hbm_util_vs_peak", "bound", "sol_headroom_x", "gpu"):
        assert line[key] is None, key
    assert line["kernel_launches"] == {"stft_features": 2, "threefry_batch": 1}


def test_roofline_shares_and_the_over_peak_check():
    line = roofline.roofline(989e12 * 1e-3, 3.35e12 * 0.5e-3, 2.0, "bfloat16", True)
    assert line["tc_util_vs_peak"] == pytest.approx(0.5)
    assert line["hbm_util_vs_peak"] == pytest.approx(0.25)
    assert line["bound"] == "compute" and line["speed_of_light_ms"] == pytest.approx(1.0)
    assert roofline.over_peak(line) == []
    fast = roofline.roofline(989e12 * 1e-3, 0.0, 0.5, "bfloat16", True)
    assert roofline.over_peak(fast) == ["tc_util_vs_peak"]


# -- the cost module against PERF.md §6's bound column --------------------------

# ms at 3.35 TB/s, 67 TFLOP/s f32 and a threefry cipher's 40 integer-ALU
# instructions at 132 x 64 x 1.98 GHz (cost.INT32_OPS_PER_S)
BOUNDS = {
    "K1 bench mixtures": (lambda: cost.stft_features(
        128, 23936, 512, 128, ("mag", "logmag", "logmel"), 80), 0.0204),
    "K1 bench targets": (lambda: cost.stft_features(
        256, 23936, 512, 128, ("mag", "logmag")), 0.0362),
    "K2 separate()": (lambda: cost.masked_istft(16, 2, 184, 512, 128), 0.00453),
    "K2 music bound": (lambda: cost.masked_istft(8, 2, 255, 2048, 512, "complex"), 0.0175),
    "K3": (lambda: cost.istft(64, 247, 512, 128), 0.01215),
    "K3 VJP": (lambda: cost.istft_adjoint(64, 247, 512, 128), 0.01215),
    "K4": (lambda: cost.stft(64, 32000, 512, 128), 0.01215),
    "sampler": (lambda: cost.sample(32, 32000, "normal"), 0.00245),
    "dropout": (lambda: cost.dropout(128 * 32 * 123 * 65, 2), 0.0783),
    "dropout VJP": (lambda: cost.dropout_mask(128 * 32 * 123 * 65, 2), 0.0403),
    "noise": (lambda: cost.noise(128 * 123 * 257 * 4, 2), 0.0387),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_cost_module_reproduces_the_bound_column(name):
    make, want = BOUNDS[name]
    ms, _ = make().bound()
    assert ms == pytest.approx(want, rel=5e-3), (name, ms)

"""Host-batch training through the captured step's dispatch, on the CPU.

A CUDA graph runs only on the card (`chip_smoke.py`'s graph phase holds
host-batch replays to eager steps there, bit for bit, on the same host
batches).  Here `GraphedStep` is replaced by a stand-in that runs the step
eagerly on the tensors it was built on, and `Experiment.graphed` is forced
on, so that what the dispatch does around a replay is tested: one static
batch that every host batch is copied into, in order, the warm-up steps
included; a batch of another shape or dtype refused; the prefetch thread
gone afterwards, also under fast thread switching; the final state that of
eager host-batch steps, which read the same static batch; HostBatches, the
tools' batch source; the static batch kept over a reseed; three staged
steps against the JAX package's jitted host-batch step on the same numpy
batches; page-locking held back while a capture runs."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from test_torch_corpus import _Numbered

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.config import MeshConfig
from gan_sass_tf_tpu.parallel import batch_sharding, make_mesh
from gan_sass_tf_tpu.train import Experiment as JExperiment
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.data import SyntheticDataset
from gan_sass_tf_tpu_torch.train import Experiment, experiment
from gan_sass_tf_tpu_torch.train.experiment import HostBatches
from gan_sass_tf_tpu_torch.train import graphed
from gan_sass_tf_tpu_torch.train.graphed import GraphedStep

METRICS = ("d_loss", "g_loss", "g_adv", "g_recon", "d_real_logit", "d_fake_logit")


def _cfg(**train):
    """wsj0_logmel, the main path's preset, at narrow widths in f32, batch 2
    of 0.25 s, with host batches (data.device_bank off)."""
    cfg = config.get_config("wsj0_logmel")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16), d_channels=(8, 16),
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **{"batch_size": 2, **train}),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25, device_bank=False),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))


class _Fixed:
    """A host dataset that serves the given batches in order."""

    def __init__(self, batches):
        self.batches = list(batches)

    def batch(self):
        return self.batches.pop(0)


def _stage(monkeypatch) -> list:
    """Force `Experiment.graphed` on and replace GraphedStep by a CPU
    stand-in that runs each step eagerly on the tensors it was built on;
    returns the list of the stand-ins made, in order."""
    made = []

    class StandIn(GraphedStep):
        def __init__(self, train_step, state, data, key, world=1):
            self.state, self.data, self.key = state, data, key
            self.fn = lambda: train_step(state, data, key)
            self.steps = 0
            made.append(self)

        def run(self, n):
            for _ in range(n):
                metrics = self.fn()[1]
                self.steps += 1
            return metrics

    monkeypatch.setattr(experiment, "GraphedStep", StandIn)
    monkeypatch.setattr(Experiment, "graphed", property(lambda self: True))
    return made


@pytest.fixture
def staged(monkeypatch):
    return _stage(monkeypatch)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _prefetch_alive() -> bool:
    return any(t.name == "host-batch-prefetch" for t in threading.enumerate())


def test_train_copies_each_host_batch_into_one_static_batch(staged):
    """train(5): one stand-in, built on one static batch that every step
    reads (its identity never changes), which holds batches 0 to 4 in turn,
    the warm-up steps' included; the prefetch thread is gone afterwards."""
    cfg = _cfg()
    exp = Experiment(cfg, device="cpu")
    exp.dataset = _Numbered((2, 2, cfg.segment_samples))
    seen, values, step = [], [], exp._train_step

    def reading_step(state, data, key):
        seen.append(data)
        values.append(float(data[0, 0, 0]))
        assert torch.equal(data, torch.full_like(data, values[-1]))
        return step(state, data, key)

    exp._train_step = reading_step
    m = exp.train(num_steps=5)
    assert len(staged) == 1 and staged[0].steps == 5
    static = staged[0].data
    assert static is exp._batch and static.shape == (2, 2, cfg.segment_samples)
    assert len(seen) == 5 and all(d is static for d in seen)
    assert values == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert int(exp.state.step) == 5 and all(np.isfinite(v) for v in m.values())
    assert not _prefetch_alive()


@pytest.mark.parametrize("wrong", ["shape", "dtype", "train"])
def test_a_host_batch_of_another_shape_or_dtype_raises(staged, wrong):
    """A batch whose shape or dtype is not the static batch's raises
    ValueError before any step, through run_steps and through train()
    (whose prefetch thread is gone afterwards); nothing runs eagerly."""
    cfg = _cfg()
    exp = Experiment(cfg, device="cpu")
    exp.train(num_steps=1)
    t = cfg.segment_samples
    bad = {"shape": torch.zeros(2, 2, t + 1), "dtype": torch.zeros(2, 2, t, dtype=torch.float64),
           "train": np.zeros((2, 2, t - 1), np.float32)}[wrong]
    with pytest.raises(ValueError, match="captured on"):
        if wrong == "train":
            exp.dataset = _Fixed([bad])
            exp.train(num_steps=1)
        else:
            exp.run_steps(1, lambda: bad)
    assert int(exp.state.step) == 1 and len(staged) == 1 and staged[0].steps == 1
    assert not _prefetch_alive()


def test_eager_host_batch_steps_read_the_static_batch_too():
    """Without a graph (the CPU, the debug tripwires) each host batch is
    copied into the same static batch that a capture would hold, and a
    batch of another shape raises ValueError before any step."""
    cfg = _cfg()
    exp = Experiment(cfg, device="cpu")
    assert not exp.graphed
    exp.dataset = _Numbered((2, 2, cfg.segment_samples))
    seen, step = [], exp._train_step

    def reading_step(state, data, key):
        seen.append((data, float(data[0, 0, 0])))
        return step(state, data, key)

    exp._train_step = reading_step
    exp.train(num_steps=3)
    assert [v for _, v in seen] == [0.0, 1.0, 2.0]
    assert all(d is exp._batch for d, _ in seen)
    with pytest.raises(ValueError, match="captured on"):
        exp.run_steps(1, lambda: np.zeros((1, 2, cfg.segment_samples), np.float32))
    assert int(exp.state.step) == 3 and len(seen) == 3


def test_host_batches_draw_ahead_cycle_and_go_back():
    """HostBatches draws its `keep` batches when made, hands them out in
    turn and again from the first, and set back hands out the same ones."""
    cfg = _cfg()
    exp = Experiment(cfg, device="cpu")
    exp.dataset = _Numbered((2, 2, cfg.segment_samples))
    batches = HostBatches(exp, 3)
    assert exp.dataset.served == 3
    assert [float(batches()[0, 0, 0]) for _ in range(5)] == [0.0, 1.0, 2.0, 0.0, 1.0]
    batches.at = 1
    assert [float(batches()[0, 0, 0]) for _ in range(2)] == [1.0, 2.0]
    assert exp.dataset.served == 3


def test_staged_steps_equal_eager_host_batch_steps(monkeypatch):
    """Five staged steps (the static batch, the stand-in) leave the state
    that five eager host-batch steps of the same seed leave, tensor for
    tensor."""
    cfg = _cfg()
    eager = Experiment(cfg, device="cpu")
    assert not eager.graphed
    eager.train(num_steps=5)
    made = _stage(monkeypatch)
    exp = Experiment(cfg, device="cpu")
    exp.train(num_steps=5)
    assert len(made) == 1 and exp._batch is not None
    ours, ref = exp.state.state_dict(), eager.state.state_dict()
    flat = dict(experiment._named_tensors(ours))
    for k, v in experiment._named_tensors(ref):
        assert torch.equal(flat[k], v), k


def test_reseed_keeps_the_static_batch_and_stages_anew(staged):
    """After a reseed the next steps build a new stand-in on the new state
    and the same static batch."""
    exp = Experiment(_cfg(), device="cpu")
    exp.train(num_steps=2)
    static = exp._batch
    exp.reseed(1)
    m = exp.train(num_steps=2)
    assert len(staged) == 2 and staged[1].state is exp.state
    assert staged[0].data is staged[1].data is exp._batch is static
    assert int(exp.state.step) == 2 and all(np.isfinite(v) for v in m.values())


def test_three_staged_steps_match_the_jax_host_batch_step(staged):
    """Three staged steps of the port (its seeded init and train key, each
    numpy host batch copied into the static batch) against the JAX
    package's jitted host-batch step on a one-device mesh from its own
    seeded init and train key on the same batches: every metric within 1e-4
    relative at each step, and after step 3 every G and D parameter within
    1e-2·lr of the reference's (the f32 step tolerances of
    tests/test_torch_train.py)."""
    cfg = _cfg(log_every=1)
    jcfg = j_config.Config.from_json(cfg.to_json())
    ds = SyntheticDataset(cfg, seed=3)
    batches = [ds.batch() for _ in range(3)]
    mesh = make_mesh(MeshConfig(data_axis_size=1), devices=jax.devices()[:1])
    jexp = JExperiment(jcfg, workdir=None, mesh=mesh)
    ref = []
    for src in batches:
        jexp.state, m = jexp._train_step(jexp.state, jax.device_put(src, batch_sharding(mesh)),
                                         jexp._train_rng)
        ref.append({k: float(v) for k, v in m.items()})

    exp = Experiment(cfg, device="cpu")
    exp.dataset = _Fixed(batches)
    got = []
    exp.train(num_steps=3, log_fn=lambda s, row: got.append(row))
    assert len(staged) == 1 and staged[0].steps == 3 and len(got) == 3
    for step, (t, j) in enumerate(zip(got, ref), 1):
        for k in METRICS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"{k} after step {step}")
    for ours, theirs, lr, what in (
            (tmodels.generator_params_to_flax(exp.state.g.state_dict()),
             jexp.state.g_params, cfg.train.g_lr, "G"),
            (tmodels.discriminator_variables_to_flax(exp.state.d.state_dict())["params"],
             jexp.state.d_params, cfg.train.d_lr, "D")):
        theirs = dict(_flat(theirs))
        for k, v in _flat(ours):
            np.testing.assert_allclose(v, theirs[k], atol=1e-2 * lr, rtol=0,
                                       err_msg=f"{what} {k} after step 3")


def test_prefetch_hands_every_batch_once_in_order_under_fast_switching(staged):
    """Forty staged steps of a stand-in step that only reads its batch, the
    interpreter switching threads every 10 µs: the step sees batches 0 to
    39 once each, in order, and the prefetch thread is gone afterwards."""
    cfg = _cfg(log_every=10)
    exp = Experiment(cfg, device="cpu")
    exp.dataset = _Numbered((2, 2, cfg.segment_samples))
    seen = []

    def reading_step(state, data, key):
        seen.append(float(data[0, 0, 0]))
        return state, {k: torch.zeros(()) for k in METRICS}

    exp._train_step = reading_step
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        exp.train(num_steps=40)
    finally:
        sys.setswitchinterval(interval)
    assert seen == [float(i) for i in range(40)]
    assert not _prefetch_alive()


def test_pin_waits_for_a_capture(monkeypatch):
    """`graphed.pin` from another thread does not run while a capture
    holds `capture_lock`, and runs once it is released (page-locking is
    stubbed: the CPU build of torch has none)."""
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self.clone())
    done = threading.Event()
    worker = threading.Thread(target=lambda: (graphed.pin(torch.ones(3)), done.set()))
    with graphed.capture_lock:
        worker.start()
        assert not done.wait(0.2)
    worker.join(timeout=10)
    assert done.is_set() and not worker.is_alive()

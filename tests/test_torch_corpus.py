"""The port's wav-corpus data against the JAX package's, bit for bit on a
fixture corpus (the copied fixture writer, `WavDirDataset` with its
held-out speaker split and `build_bank`), and host-batch training: the
prefetch thread feeds the step the dataset's batches in order."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.data.corpus import WavDirDataset as JWavDirDataset
from gan_sass_tf_tpu.data.device_bank import build_bank as j_build_bank
from gan_sass_tf_tpu.data.fixtures import write_fixture_corpus as j_write_fixture_corpus
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import data as tdata
from gan_sass_tf_tpu_torch.data.fixtures import write_fixture_corpus
from gan_sass_tf_tpu_torch.train import Experiment, build_train_step, create_train_state

N_SPEAKERS = 6       # the eval split holds out max(2, 6 // 5) = 2 speakers


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    write_fixture_corpus(str(root), n_speakers=N_SPEAKERS, utts_per_speaker=3,
                         seconds=0.5, sample_rate=8000, seed=2)
    return str(root)


def _cfg(corpus, name="wsj0_logmel", **data):
    cfg = config.get_config(name)
    data = {"dataset": "wav_dir", "data_dir": corpus, "segment_seconds": 0.25,
            "bank_utterances": 3, **data}
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16), d_channels=(8, 16),
                                  compute_dtype="float32"),
        dsp=dataclasses.replace(cfg.dsp, n_mels=32),
        train=dataclasses.replace(cfg.train, batch_size=2, log_every=1),
        data=dataclasses.replace(cfg.data, **data))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


def test_fixture_corpus_matches_jax(tmp_path):
    ours = write_fixture_corpus(str(tmp_path / "a"), n_speakers=3,
                                utts_per_speaker=2, seconds=0.3, seed=5)
    ref = j_write_fixture_corpus(str(tmp_path / "b"), n_speakers=3,
                                 utts_per_speaker=2, seconds=0.3, seed=5)
    assert [os.path.relpath(p, tmp_path / "a") for p in ours] == \
        [os.path.relpath(p, tmp_path / "b") for p in ref]
    for a, b in zip(ours, ref):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


# wsj0_logmel reads the 8 kHz corpus as it is; stream_v5e8 resamples it to
# 16 kHz (resample_poly).  segment_seconds 1.0 pads the 0.5 s utterances.
@pytest.mark.parametrize("name,seconds", [("wsj0_logmel", 0.25),
                                          ("stream_v5e8", 0.25),
                                          ("wsj0_logmel", 1.0)])
@pytest.mark.parametrize("split", ["train", "eval", "all"])
def test_wav_dir_batches_bit_identical(corpus, name, seconds, split):
    cfg = _cfg(corpus, name, segment_seconds=seconds)
    ours = tdata.make_dataset(cfg, seed=7, split=split)
    ref = JWavDirDataset(_jax(cfg), seed=7, split=split)
    assert isinstance(ours, tdata.WavDirDataset)
    assert ours.speakers == ref.speakers
    assert len(ours.speakers) == {"train": 4, "eval": 2, "all": N_SPEAKERS}[split]
    for _ in range(2):
        a, b = ours.batch(), ref.batch()
        assert a.shape == (2, 2, cfg.segment_samples) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_build_bank_from_corpus_matches_jax(corpus):
    cfg = _cfg(corpus, "stream_v5e8")
    bank = tdata.build_bank(cfg, seed=3)
    assert bank.shape == (2, 3, cfg.segment_samples)
    np.testing.assert_array_equal(bank, j_build_bank(_jax(cfg), seed=3))


def test_wav_dir_too_few_speakers(tmp_path):
    write_fixture_corpus(str(tmp_path), n_speakers=1, utts_per_speaker=1,
                         seconds=0.3)
    with pytest.raises(ValueError, match="need ≥ 2 speakers"):
        tdata.make_dataset(_cfg(str(tmp_path)))


class _Numbered:
    """A host dataset whose i-th batch is filled with i."""

    def __init__(self, shape):
        self.shape, self.served = shape, 0
        self.lock = threading.Lock()

    def batch(self):
        with self.lock:
            self.served += 1
            return np.full(self.shape, self.served - 1, np.float32)


def test_host_batches_reach_the_step_in_order(corpus):
    cfg = _cfg(corpus, device_bank=False)
    exp = Experiment(cfg, device="cpu")
    assert exp._bank is None and isinstance(exp.dataset, tdata.WavDirDataset)
    exp.dataset = _Numbered((2, 2, cfg.segment_samples))
    seen, step = [], exp._train_step

    def recording_step(state, data, seed):
        seen.append(float(data[0, 0, 0]))
        return step(state, data, seed)

    exp._train_step = recording_step
    m = exp.train(num_steps=3)
    assert seen == [0.0, 1.0, 2.0] and exp.state.step == 3
    assert all(np.isfinite(v) for v in m.values())
    assert not any(t.name == "host-batch-prefetch" for t in threading.enumerate())


def test_host_batch_step_equals_a_direct_step(corpus):
    """Experiment.train(1) in host-batch mode is train_step(state, batch,
    seed) on the dataset's first batch, tensor for tensor."""
    cfg = _cfg(corpus, device_bank=False)
    exp = Experiment(cfg, device="cpu")
    exp.train(num_steps=1)
    state = create_train_state(cfg, "cpu", cfg.train.seed)
    batch = tdata.make_dataset(cfg, seed=cfg.train.seed).batch()
    state, _ = build_train_step(cfg)(state, torch.from_numpy(batch),
                                     tdata.prng_key(cfg.train.seed + 1))
    for a, b in ((exp.state.g, state.g), (exp.state.d, state.d)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k


def test_host_batch_error_reaches_the_train_loop(corpus):
    exp = Experiment(_cfg(corpus, device_bank=False), device="cpu")

    class Broken:
        def batch(self):
            raise OSError("unreadable wav")

    exp.dataset = Broken()
    with pytest.raises(OSError, match="unreadable wav"):
        exp.train(num_steps=2)

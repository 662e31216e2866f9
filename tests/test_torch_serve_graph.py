"""The port's compiled serving and eval, on the CPU: the memos that stand
for the JAX package's jitted `separate_fn_for`, `streaming_scan_fn_for`
and `Experiment._eval_step`, the scan streamer's chunk body with its carry
explicit, and the eval step keyed by a tensor seed.

A CUDA graph runs only on the card (`chip_smoke.py`'s serve_graph phase
holds every replayed path to its eager one there).  Here the memos are
held to their keys and bounds (with `GraphedCall` replaced by a stub where
the key is a shape), the CPU routes to the eager functions, and what a
capture needs is held bit for bit to the eager loop and to the JAX
package: the chunk body reads no number on the host, the eval takes its
seed as a tensor."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.infer import streaming as j_streaming
from gan_sass_tf_tpu.train.step import build_eval_step as j_build_eval_step
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.infer import streaming
from gan_sass_tf_tpu_torch.infer.separate import separate_fn_for
from gan_sass_tf_tpu_torch.ops import dispatch
from gan_sass_tf_tpu_torch.parallel import DataParallel
from gan_sass_tf_tpu_torch.train import Experiment, graphed
from gan_sass_tf_tpu_torch.train.step import (
    build_eval_step,
    build_separate_fn,
    eval_fn_for,
)

SR = 8000
MEMOS = {"separate_fn_for": separate_fn_for,
         "streaming_scan_fn_for": streaming.streaming_scan_fn_for,
         "eval_fn_for": eval_fn_for}


def _cfg(num_sources=2, **stream):
    cfg = config.get_config("2src_toy_cpu")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16)),
        data=dataclasses.replace(cfg.data, num_sources=num_sources),
        stream=dataclasses.replace(cfg.stream, **stream))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


def _weights(cfg, seed=0):
    """Seeded flax G params of `cfg` and the port's G carrying them."""
    g = jmodels.build_generator(_jax(cfg))
    feats = jnp.zeros((1, 16, cfg.dsp.feature_dim), jnp.float32)
    params = g.init(jax.random.PRNGKey(seed), feats)["params"]
    return params, tmodels.load_generator(cfg, jax.tree.map(np.asarray, params),
                                          "cpu")


def _tones(seconds, freqs=(300.0, 1500.0)):
    n = np.arange(int(seconds * SR)) / SR
    return sum(np.sin(2 * np.pi * f * n) / (i + 1)
               for i, f in enumerate(freqs)).astype(np.float32)


class _StubCall:
    """Stands for a GraphedCall where there is no card: records its
    arguments' shapes."""

    def __init__(self, fn, *args):
        self.fn, self.shapes = fn, [getattr(a, "shape", None) for a in args]


@pytest.mark.parametrize("name", sorted(MEMOS))
def test_memo_keyed_by_config_and_generator_bounded_at_eight(name):
    """Each memo gives one entry per (cfg, G), the same entry for the same
    pair, and holds MEMO_SIZE (8) of them as the JAX package's
    lru_cache(maxsize=8): the ninth pair evicts the least recently used."""
    memo = MEMOS[name]
    memo.cache_clear()
    cfg, other_cfg = _cfg(), _cfg(chunk_seconds=0.5)
    gs = [torch.nn.Module() for _ in range(graphed.MEMO_SIZE)]
    args = [DataParallel()] if name == "eval_fn_for" else []   # eval_fn_for's dp
    first = memo(cfg, gs[0], *args)
    assert memo(cfg, gs[0], *args) is first
    oldest = memo(other_cfg, gs[0], *args)
    assert oldest is not first
    kept = [memo(cfg, g, *args) for g in gs[1:7]]
    assert len({id(e) for e in kept + [first, oldest]}) == graphed.MEMO_SIZE
    assert len(memo.entries) == graphed.MEMO_SIZE
    assert memo(cfg, gs[0], *args) is first       # used again: now the newest
    memo(cfg, gs[7], *args)                       # the ninth key
    assert len(memo.entries) == graphed.MEMO_SIZE
    assert memo(cfg, gs[0], *args) is first
    assert [memo(cfg, g, *args) for g in gs[1:7]] == kept
    assert memo(other_cfg, gs[0], *args) is not oldest     # evicted, made anew
    memo.cache_clear()


@pytest.mark.parametrize("name", sorted(MEMOS))
def test_memo_holds_the_generator_weakly(name):
    """A memo keeps no G alive: its entry is made on a proxy of G, and when
    G is gone its entries (and on the card their graphs) go too, while
    another G's stay."""
    memo = MEMOS[name]
    memo.cache_clear()
    cfg = _cfg()
    args = [DataParallel()] if name == "eval_fn_for" else []
    g, kept = tmodels.build_generator(cfg, "cpu", seed=1), torch.nn.Module()
    memo(cfg, g, *args)
    memo(_cfg(chunk_seconds=0.5), g, *args)
    entry = memo(cfg, kept, *args)
    assert len(memo.entries) == 3
    ref = weakref.ref(g)
    del g
    gc.collect()
    assert ref() is None
    assert list(memo.entries.values()) == [entry]
    memo.cache_clear()


def test_graphed_fn_one_graph_per_shape_dtype_and_backend(monkeypatch):
    """GraphedFn's graphs, jit's per-shape cache: the same signature gives
    the same entry, a new batch, length, dtype or forced DSP backend a new
    one; MEMO_SIZE of them are kept, the least recently used dropped
    first."""
    monkeypatch.setattr(graphed, "GraphedCall", _StubCall)
    fn = graphed.GraphedFn(lambda x: x)
    a = fn.graph_for(torch.zeros(2, 512))
    assert fn.graph_for(torch.ones(2, 512)) is a
    assert fn.graph_for(torch.zeros(3, 512)) is not a
    assert fn.graph_for(torch.zeros(2, 640)) is not a
    assert fn.graph_for(torch.zeros(2, 512, dtype=torch.float64)) is not a
    with dispatch.force_backend("reference"):
        assert fn.graph_for(torch.zeros(2, 512)) is not a
    assert fn.graph_for(torch.zeros(2, 512)) is a
    assert len(fn.graphs) == 5
    more = [fn.graph_for(torch.zeros(b, 512)) for b in range(10, 17)]
    assert len(fn.graphs) == graphed.MEMO_SIZE       # the four oldest dropped
    assert fn.graph_for(torch.zeros(2, 512)) is a     # the oldest, used again
    fn.graph_for(torch.zeros(99, 512))                # the ninth: (10, 512) goes
    assert fn.graph_for(torch.zeros(2, 512)) is a
    assert fn.graph_for(torch.zeros(10, 512)) is not more[0]
    assert fn.graph_for(torch.zeros(16, 512)) is more[-1]
    assert all(isinstance(c, _StubCall) for c in fn.graphs.values())
    seen = len(fn.graphs)
    fn(torch.zeros(7, 512))                               # the CPU: no graph
    assert len(fn.graphs) == seen


def test_scan_streamer_one_graph_per_chunk_length(monkeypatch):
    """The scan streamer's body is captured once per chunk length, whatever
    the stream's number of chunks, over one carry a device."""
    monkeypatch.setattr(graphed, "GraphedCall", _StubCall)
    scan = streaming.ScanStreamer(_cfg(), None)
    chunks = torch.zeros(5, 1280)
    a = scan.body.graph_for(chunks[0])
    assert scan.body.graph_for(torch.zeros(62, 1280)[0]) is a
    assert scan.body.graph_for(torch.zeros(5, 1024)[0]) is not a
    assert a.shapes == [torch.Size([1280])]
    carry = scan.carry(chunks.device)
    assert scan.carry(torch.device("cpu")) is carry
    assert carry.tail.shape == (2, 4 * 64) and bool(carry.first)


def test_separate_fn_for_on_the_cpu_is_build_separate_fn():
    """On the CPU the memo calls the eager graph: the same bits."""
    cfg = _cfg()
    g = tmodels.build_generator(cfg, "cpu", seed=3)
    mix = torch.from_numpy(np.stack([_tones(0.5), _tones(0.5, (500.0, 2100.0))]))
    got = separate_fn_for(cfg, g)(mix)
    assert torch.equal(got, build_separate_fn(cfg, g)(mix))
    assert not separate_fn_for(cfg, g).graphs


@pytest.mark.parametrize("args", [(torch.zeros(4),), (3,), ()])
def test_graphed_call_refuses_what_is_not_on_cuda(args):
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphed.GraphedCall(lambda *a: a, *args)


def _body_loop(cfg, g, chunks):
    """build_scan_step's body looped on the CPU from a reset carry: the
    (N, S, stride) segments and the final tail."""
    step = streaming.build_scan_step(cfg, g)
    overlap = cfg.stream.overlap_frames * cfg.dsp.hop_length
    carry = streaming.ScanCarry.zeros(cfg.data.num_sources, overlap, "cpu")
    carry.reset()
    segs = torch.stack([step(chunks[i], carry) for i in range(chunks.shape[0])])
    return segs, carry.tail


@pytest.mark.parametrize("hysteresis", [0.0, 1e-3])
@pytest.mark.parametrize("num_sources", [2, 3])
def test_scan_body_with_explicit_carry_is_the_eager_scan(num_sources, hysteresis):
    """The chunk body that a CUDA graph captures (chunk 0's branch chosen on
    the device, every index a device tensor, the carry updated in place),
    looped over a stream from a reset carry, gives the bits of
    build_streaming_scan_fn (which loops it from a fresh carry): its
    segments and its final tail.  At hysteresis 1e-3 both are also the jitted JAX scan's
    within 1e-3·max|ref| (tests/test_torch_streaming.py's tolerance); at 0
    the JAX scan may break chunk 0's tie against its zero carry either way,
    so there it is held to the port's eager loop alone."""
    cfg = _cfg(num_sources, chunk_seconds=0.25, perm_hysteresis=hysteresis)
    params, g = _weights(cfg, seed=num_sources)
    freqs = (300.0, 1500.0, 2700.0)[:num_sources]
    chunks, (_, stride, overlap, n, _, _) = streaming._chunk_matrix(
        cfg, _tones(1.5, freqs))
    chunks = torch.from_numpy(chunks)
    segs, tail = _body_loop(cfg, g, chunks)
    want_segs, want_tail = streaming.build_streaming_scan_fn(cfg, g)(chunks)
    assert segs.shape == (n, num_sources, stride) and n > 2
    assert tail.shape == (num_sources, overlap)
    assert torch.equal(segs, want_segs) and torch.equal(tail, want_tail)
    if hysteresis:
        ref_segs, ref_tail = jax.jit(j_streaming.build_streaming_scan_fn(
            _jax(cfg), jmodels.build_generator(_jax(cfg))))(params,
                                                          jnp.asarray(chunks.numpy()))
        scale = float(np.abs(np.asarray(ref_segs)).max())
        np.testing.assert_allclose(segs.numpy(), np.asarray(ref_segs), rtol=0,
                                   atol=1e-3 * scale)
        np.testing.assert_allclose(tail.numpy(), np.asarray(ref_tail), rtol=0,
                                   atol=1e-3 * scale)


def test_scan_streamer_on_the_cpu_is_the_eager_scan():
    """streaming_scan_fn_for on CPU chunks runs the eager loop, and
    separate_streaming_scan goes through it."""
    cfg = _cfg(chunk_seconds=0.25)
    _, g = _weights(cfg)
    mix = _tones(1.0)
    chunks = torch.from_numpy(streaming._chunk_matrix(cfg, mix)[0])
    got = streaming.streaming_scan_fn_for(cfg, g)(chunks)
    want = streaming.build_streaming_scan_fn(cfg, g)(chunks)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out = streaming.separate_streaming_scan(g, cfg, mix, "cpu")
    joined = streaming.scan_chunks(streaming.build_streaming_scan_fn(cfg, g), chunks)
    np.testing.assert_array_equal(out, joined.numpy()[..., :mix.shape[0]])


def test_eval_step_with_a_tensor_seed_is_the_int_seed_and_jax_step():
    """The eval step keyed by a 0-d int64 seed tensor (what a captured eval
    reads) gives the int-seed step's bits, and the eval memo on the CPU
    the same; both are the JAX eval step's under PRNGKey(seed) within
    1e-3 dB."""
    cfg = _cfg()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_noise=1))
    params, g = _weights(cfg, seed=5)
    sources = np.random.default_rng(11).standard_normal((3, 2, 4000)).astype(
        np.float32) * np.array([1.0, 0.5], np.float32)[:, None]
    src = torch.from_numpy(sources)
    step = build_eval_step(cfg, g)
    by_int = step(src, 10_003)
    by_tensor = step(src, torch.tensor(10_003, dtype=torch.int64))
    memo = eval_fn_for(cfg, g)(src, torch.tensor(10_003, dtype=torch.int64))
    ref = jax.jit(j_build_eval_step(_jax(cfg), jmodels.build_generator(_jax(cfg))))(
        params, jnp.asarray(sources), jax.random.PRNGKey(10_003))
    assert set(by_int) == set(ref) == {"si_sdr", "si_sdr_mix", "si_sdr_improvement"}
    for k, v in by_int.items():
        assert torch.equal(v, by_tensor[k]) and torch.equal(v, memo[k]), k
        assert abs(float(v) - float(ref[k])) <= 1e-3, (k, float(v), float(ref[k]))


def test_experiment_separate_fn_and_evaluate_use_the_memos(monkeypatch):
    """Experiment.separate_fn is the memo of its eval G, and evaluate()
    scores every batch through eval_fn_for(cfg, eval G, its DataParallel)."""
    from gan_sass_tf_tpu_torch.train import experiment

    cfg = _cfg()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2))
    exp = Experiment(cfg, device="cpu")
    g = exp.eval_generator()
    assert exp.separate_fn is separate_fn_for(cfg, g)
    seeds = []

    def recording(cfg_, g_, dp):
        assert (cfg_, g_, dp) == (cfg, g, exp.dp)
        scores = eval_fn_for(cfg_, g_, dp)

        def call(sources, seed):
            seeds.append(int(seed))
            return scores(sources, seed)
        return call

    monkeypatch.setattr(experiment, "eval_fn_for", recording)
    ev = exp.evaluate(num_batches=2)
    assert seeds == [10_000, 10_001]
    assert set(ev) == {"si_sdr", "si_sdr_mix", "si_sdr_improvement"}
    assert all(np.isfinite(v) for v in ev.values())

"""Where does streaming lose to one-shot separation on a trained G?

A run saved by the port's `stream_quality` (STREAM_QUALITY_SAVE=PATH: the
trained G, the stream and its targets) is cut into the streaming chunks
and each chunk separated by the port on one device, as
`separate_streaming` separates them (`dump`; it imports no JAX, so it runs
where the card is).  Then, on the CPU (`compare`), the chunk permutations
are chained on the same overlap strips by the port's and by the JAX
package's `_chain_permutations`, at hysteresis 0 and 1e-3, and beside
them by an oracle: each chunk's permutation that best matches the targets
on the chunk (L2).  Each chain's stream is joined by the port's
`_finalize_stream` and scored as `stream_quality` scores the stream.

    python tests/stream_chain_witness.py dump RUN.pt OUT.npz [--device cuda]
    python tests/stream_chain_witness.py compare OUT.npz [OUT2.npz ...]

`compare` prints one JSON line a chain of each file: its SI-SDR
improvement over the stream, and the chunks at which it disagrees with the
oracle chain (a flip), each with its overlap's loudness relative to the
stream's (0 where the overlap lies in a silent gap); then a line saying
whether the two packages chose the same permutations everywhere, and,
given two files, how far apart their chunk separations are.

Not a tier-1 test: it reads a saved run.
"""

from __future__ import annotations

import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gan_sass_tf_tpu_torch.infer import streaming  # noqa: E402
from gan_sass_tf_tpu_torch.scripts import stream_quality  # noqa: E402

HYSTERESES = (0.0, 1e-3)


def dump(run: str, out: str, device: str) -> None:
    """The saved run's chunks, each separated on `device` in groups of
    stream.batch_chunks as `separate_streaming` separates them, saved with
    the stream, its targets and the geometry."""
    from gan_sass_tf_tpu_torch.infer.separate import separate_fn_for

    dev = torch.device(device)
    cfg, _, _, _, g, mixture, targets = stream_quality.load_run(run, dev)
    chunks, (chunk, stride, overlap, n, _, _) = streaming._chunk_matrix(cfg, mixture)
    bc = cfg.stream.batch_chunks
    groups = -(-n // bc)
    padded = np.pad(chunks, ((0, groups * bc - n), (0, 0)))
    fn = separate_fn_for(cfg, g)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(padded)).to(dev)
        est = torch.cat([fn(x[i * bc:(i + 1) * bc])[..., :chunk]
                         for i in range(groups)])[:n].float().cpu().numpy()
    np.savez(out, est=est, mixture=mixture, targets=targets,
             scale=np.float64(np.mean(chunks ** 2)),
             geometry=np.array([chunk, stride, overlap]),
             device=np.array(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                             else "cpu"))


def oracle_chain(est: np.ndarray, targets: np.ndarray, stride: int) -> np.ndarray:
    """(N, S) each chunk's permutation nearest the targets on its span."""
    n, s, t_c = est.shape
    perms = list(itertools.permutations(range(s)))
    out = np.zeros((n, s), np.int64)
    for i in range(n):
        tgt = targets[:, i * stride: i * stride + t_c]
        e = est[i][:, : tgt.shape[-1]]
        out[i] = min(perms, key=lambda p: float(np.sum((e[list(p)] - tgt) ** 2)))
    return out


def score(est, perm, mixture, targets, stride, overlap) -> float:
    full = streaming._finalize_stream(torch.from_numpy(est), torch.from_numpy(perm),
                                      stride, overlap).numpy()
    return stream_quality.si_sdr_improvement(full[..., : mixture.shape[-1]], targets,
                                             mixture)


def compare(path: str) -> tuple:
    """One JSON line a chain of the dumped file; (the chains' permutations,
    the port's equal to JAX's, est)."""
    from gan_sass_tf_tpu.infer import streaming as j_streaming

    d = np.load(path)
    est, mixture, targets = d["est"], d["mixture"], d["targets"]
    chunk, stride, overlap = (int(v) for v in d["geometry"])
    heads, tails = est[:, :, :overlap], est[:, :, stride: stride + overlap]
    level = float(np.mean(mixture ** 2))
    loud = [float(np.mean(mixture[i * stride: i * stride + overlap] ** 2)) / level
            for i in range(est.shape[0])]
    oracle = oracle_chain(est, targets, stride)
    chains, same = {"oracle": oracle}, True
    for h in HYSTERESES:
        ours = streaming._chain_permutations(heads, tails, h, scale=float(d["scale"]))
        ref = j_streaming._chain_permutations(heads, tails, h, scale=float(d["scale"]))
        same &= bool(np.array_equal(ours, ref))
        chains[f"hysteresis {h:g}"] = ours
    for name, perm in chains.items():
        # A flip: the chunk's order relative to its predecessor differs
        # from the oracle's relative order.
        flips = [i for i in range(1, len(perm))
                 if not np.array_equal(perm[i][np.argsort(perm[i - 1])],
                                       oracle[i][np.argsort(oracle[i - 1])])]
        print(json.dumps({
            "file": os.path.basename(path), "device": str(d["device"]), "chain": name,
            "si_sdr_improvement": round(score(est, perm, mixture, targets, stride,
                                              overlap), 2),
            "flips_against_oracle": [{"chunk": i, "overlap_loudness": round(loud[i], 4)}
                                     for i in flips]}), flush=True)
    return chains, same, est


def main(argv) -> int:
    if argv[:1] == ["dump"] and len(argv) >= 3:
        device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
        dump(argv[1], argv[2], device)
        return 0
    if argv[:1] == ["compare"] and len(argv) >= 2:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        runs = [compare(p) for p in argv[1:]]
        line = {"port_chains_equal_jax": all(r[1] for r in runs)}
        if len(runs) == 2:
            a, b = runs[0][2], runs[1][2]
            line["est_max_abs_diff_over_max"] = float(np.abs(a - b).max() / np.abs(a).max())
            line["same_chains"] = {k: bool(np.array_equal(runs[0][0][k], runs[1][0][k]))
                                   for k in runs[0][0]}
        print(json.dumps(line), flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

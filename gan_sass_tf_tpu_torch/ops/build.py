"""Build the CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` source (with the `csrc/*.cuh` headers it includes)
compiles to an object in its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  The library is keyed by a
hash of the sources, the headers and the flags and lives in
`build_dir()`: `ops/_build/` (ignored by git) in a checkout or any
writable install, else `${XDG_CACHE_HOME:-~/.cache}/gan_sass_tf_tpu_torch/`
for a package installed read-only.  The first CUDA call builds it and
later processes reuse it.  Nothing happens at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)
_F = ctypes.c_float
_SIGNATURES = {
    # x, win, tw, tws, ptw, mel, bands, spec, mag, logmag, logmel, B, T, F,
    # n_fft, hop, M, eps, rounds, per_sm, stream, device
    "stft_features_launch": [_P] * 11 + [_I] * 6 + [ctypes.c_float, _I, _I, _P, _I],
    # x, win, tw, tws, ptw, spec, B, T, F, n_fft, hop, rounds, per_sm,
    # stream, device
    "stft_launch": [_P] * 6 + [_I] * 7 + [_P, _I],
    # dy, inv_env, win, tw, tws, ptw, dspec, B, T, F, n_fft, hop, rounds,
    # per_sm, stream, device
    "istft_adjoint_launch": [_P] * 7 + [_I] * 7 + [_P, _I],
    # plan (ops/masked_istft.py::_Plan, filled in)
    "synthesis_prepare": [_P],
    # plan, spec, masks, out, stream
    "masked_istft_launch": [_P] * 5,
    # plan, spec, out, stream
    "istft_launch": [_P] * 4,
    # keys, R, n, kind, lo, hi, span, mult, minval, out, stream
    "threefry_sample_launch": [_P, _I, _I, _I, _F, _F, _L, _L, _L, _P, _P],
    # args (ops/threefry.py::BatchArgs), blocks, stream
    "threefry_batch_launch": [_P, _I, _P],
    # x, y, words, key, fold, keep_below, scale, n, size, jstride, wrap, bf16,
    # blocks, stream
    "threefry_dropout_launch": [_P, _P, _P, _P, _L, _L, _F, _L, _LP, _LP, _LP, _I, _I,
                                _P],
    # dy, words, dx, scale, n, bf16, blocks, stream
    "dropout_mask_launch": [_P, _P, _P, _F, _L, _I, _I, _P],
    # x, y, key, coef, n, bf16, blocks, stream
    "threefry_noise_launch": [_P, _P, _P, _F, _L, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_build_dir: Optional[Path] = None       # chosen once a process
build_seconds: Optional[float] = None   # wall time of this process's build
build_log: str = ""                     # nvcc's output (ptxas register use)


def _sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu"))


def _headers(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
        "kernels are built from source on first use and need the toolkit"
    )


def _writable(d: Path) -> bool:
    """Whether files can be made in `d`, made here (with its parents) if
    missing.  A directory whose mode bits grant no write counts as read-only
    even to root, whom the kernel would let through: a package installed
    read-only stays untouched."""
    top = d
    while not top.exists():
        top = top.parent
    if not (top.is_dir() and top.stat().st_mode & 0o222
            and os.access(top, os.W_OK | os.X_OK)):
        return False
    try:
        d.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    return True


def build_dir() -> Path:
    """Where the library is built: `ops/_build/` beside this module where
    that can be written, else `${XDG_CACHE_HOME:-~/.cache}/
    gan_sass_tf_tpu_torch/`.  Chosen at the first call of a process;
    RuntimeError, naming both, where neither can be written."""
    global _build_dir
    if _build_dir is None:
        in_tree = _HERE / "_build"
        cache = Path(os.environ.get("XDG_CACHE_HOME")
                     or Path.home() / ".cache") / "gan_sass_tf_tpu_torch"
        for d in (in_tree, cache):
            if _writable(d):
                _build_dir = d
                break
        else:
            raise RuntimeError(
                f"no writable directory for the CUDA kernels' build: neither "
                f"{in_tree} nor {cache} can be created and written (set "
                f"XDG_CACHE_HOME to a writable directory)")
    return _build_dir


def library_path(defines: Sequence[str] = (), csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for src in _sources(csrc) + _headers(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libgan_sass_kernels_{h.hexdigest()[:16]}.so"


def build(defines: Sequence[str] = (), csrc: Path = CSRC) -> Path:
    """Compile the kernels unless a library for these sources (and these
    -D flags) exists."""
    global build_seconds, build_log
    out = library_path(defines, csrc)
    if out.exists():
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources(csrc)]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *defines, "-c", "-o", obj,
                                   str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(_sources(csrc), objs)]
        build_log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        lib = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_log}")
        os.replace(lib, out)      # atomic: concurrent builders agree
    build_seconds = time.perf_counter() - t0
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _load(build())
    return _lib


def load_variant(defines: Sequence[str] = (), csrc: Path = CSRC) -> ctypes.CDLL:
    """A library built with extra -D flags (e.g. the analysis kernel's
    STFT_THREADS), or from an edited copy of the sources in `csrc`, beside
    the process's own, which it does not replace; scripts/time_analysis.py
    times block shapes and edited kernels with it."""
    return _load(build(defines, csrc))


def check_launch(rc: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaGetLastError()."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")

"""Build the CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` source (with the `csrc/*.cuh` headers it includes)
compiles to an object in its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  The library is keyed by a
hash of the sources, the headers and the flags and lives in
`ops/_build/` (ignored by git), so the first CUDA call of a fresh checkout
builds it and later processes reuse it.  Nothing happens at import time.
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
from typing import Optional

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, win, tw, tws, mel, spec, mag, logmag, logmel, B, T, F, n_fft, hop,
    # M, eps, stream, device
    "stft_features_launch": [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P, _I],
    # x, win, tw, tws, spec, B, T, F, n_fft, hop, stream, device
    "stft_launch": [_P] * 5 + [_I] * 5 + [_P, _I],
    # dy, inv_env, win, tw, tws, dre, dim, B, T, F, n_fft, hop, stream, device
    "istft_adjoint_launch": [_P] * 7 + [_I] * 5 + [_P, _I],
    # spec, masks, win, tw, tws, inv_env, out, B, S, F, n_fft, hop,
    # complex_mask, rows, tile, stream, device
    "masked_istft_launch": [_P] * 7 + [_I] * 8 + [_P, _I],
    # re, im, win, tw, tws, inv_env, out, B, F, n_fft, hop, rows, tile,
    # stream, device
    "istft_launch": [_P] * 7 + [_I] * 6 + [_P, _I],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log: str = ""                     # nvcc's output (ptxas register use)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
        "kernels are built from source on first use and need the toolkit"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgan_sass_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(_sources(), objs)]
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


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(rc: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaGetLastError()."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")

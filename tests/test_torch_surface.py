"""The port's public surface against the JAX package's: what an installed
wheel ships (the CUDA sources and headers, the console script, no built
library), where the kernels are built (`ops.build.build_dir`), the model
registry's extension API, and every name the JAX package's `__init__`
files export."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import ast
import dataclasses
import fnmatch
import importlib
import importlib.util
import re
import shutil
import subprocess
import sys
import tomllib
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.models import discriminator as tdisc
from gan_sass_tf_tpu_torch.models import registry
from gan_sass_tf_tpu_torch.models.convert import flax_init_discriminator_
from gan_sass_tf_tpu_torch.models.generator import init_params_
from gan_sass_tf_tpu_torch.ops import build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gan_sass_tf_tpu_torch"
OPS = PORT / "ops"

# The JAX exports the port has no counterpart of, each with its reason.
# The JAX mesh is a jax.sharding.Mesh with NamedShardings placed by
# jax.device_put; the port's data parallelism is a torch.distributed
# process group in which each rank holds its own rows (parallel/mesh.py).
NOT_PORTED = {
    "parallel": {
        "make_mesh": "stand-in: mesh_shape (the (dcn, data) shape) and "
                     "data_parallel (the process group of a MeshConfig)",
        "batch_sharding": "stand-in: DataParallel.batch_rows (a rank's rows "
                          "of the global batch)",
        "replicated_sharding": "stand-in: DataParallel.broadcast_ (rank 0's "
                               "tensors on every rank)",
        "shard_batch": "stand-in: DataParallel.batch_rows (each rank reads "
                       "and uploads only its own rows)",
    },
}
SUBPACKAGES = ("", "data", "dsp", "infer", "losses", "models", "ops",
               "parallel", "train", "utils")


def _pyproject():
    return tomllib.loads((ROOT / "pyproject.toml").read_text())


def test_package_data_ships_kernel_sources():
    """Every source and header nvcc compiles matches a package-data glob
    of gan_sass_tf_tpu_torch.ops, the port's packages are found, and the
    console script runs the port's CLI."""
    meta = _pyproject()
    globs = meta["tool"]["setuptools"]["package-data"]["gan_sass_tf_tpu_torch.ops"]
    files = build._sources() + build._headers()
    assert {p.name for p in files} >= {"fft.cuh", "masked_istft.cu", "stft_features.cu"}
    for path in files:
        rel = path.relative_to(OPS).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
    assert "gan_sass_tf_tpu_torch*" in meta["tool"]["setuptools"]["packages"]["find"]["include"]
    assert meta["project"]["scripts"]["gan-sass-torch"] == "gan_sass_tf_tpu_torch.cli:main"
    assert meta["project"]["optional-dependencies"]["torch"]


def _requirement_names(reqs):
    return {re.match(r"[A-Za-z0-9_.-]+", r).group(0).lower() for r in reqs}


def test_torch_extra_names_no_jax():
    """The torch extra adds no package of the JAX stack.  The base list
    still names it (the JAX package's own requirements, which the port's
    packaging edits may not move), so `pip install .[torch]` installs JAX
    too: an open fault (ROADMAP.md §3), held here as it stands."""
    meta = _pyproject()["project"]
    torch_extra = _requirement_names(meta["optional-dependencies"]["torch"])
    assert torch_extra == {"torch"}, torch_extra
    assert _requirement_names(meta["dependencies"]) >= {
        "jax", "flax", "optax", "orbax-checkpoint"}


def test_wheel_holds_sources_and_no_library(tmp_path):
    """A wheel built from a tree whose ops/_build/ holds a library ships
    the CUDA sources and headers, no library, and the console script."""
    src = tmp_path / "src"
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    for name in ("gan_sass_tf_tpu", "gan_sass_tf_tpu_torch"):
        shutil.copytree(ROOT / name, src / name, ignore=ignore)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    lib = src / "gan_sass_tf_tpu_torch" / "ops" / "_build" / "libgan_sass_kernels_0.so"
    lib.parent.mkdir(exist_ok=True)
    lib.write_bytes(b"\0")
    res = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                          "--no-build-isolation", "--no-index", "-q", "-w",
                          str(tmp_path / "dist"), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    wheel, = (tmp_path / "dist").glob("*.whl")
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
        scripts = z.read(next(n for n in names
                              if n.endswith(".dist-info/entry_points.txt"))).decode()
    csrc = sorted(n.rsplit("/", 1)[1] for n in names
                  if n.startswith("gan_sass_tf_tpu_torch/ops/csrc/"))
    assert csrc == sorted(p.name for p in build._sources() + build._headers())
    assert not [n for n in names if n.endswith(".so") or "/_build/" in n]
    assert "gan-sass-torch = gan_sass_tf_tpu_torch.cli:main" in scripts.splitlines()
    assert "gan_sass_tf_tpu_torch/cli.py" in names


def _build_module(ops_dir: Path):
    """A fresh copy of ops/build.py loaded from `ops_dir` (its own choice of
    build directory, made at its first build_dir() call)."""
    name = f"_build_copy_{abs(hash(str(ops_dir)))}"
    spec = importlib.util.spec_from_file_location(name, ops_dir / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def ops_copy(tmp_path):
    """ops/ copied under tmp_path; write permission restored afterwards."""
    ops = tmp_path / "pkg" / "ops"
    shutil.copytree(OPS, ops, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    yield ops
    for d in (tmp_path / "pkg", tmp_path / "ro"):
        if d.exists():
            subprocess.run(["chmod", "-R", "u+w", str(d)], check=True)


def test_build_dir_in_tree_when_writable(ops_copy, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    mod = _build_module(ops_copy)
    assert mod.build_dir() == ops_copy / "_build"
    assert (ops_copy / "_build").is_dir()
    assert mod.library_path().parent == mod.build_dir()
    assert not (tmp_path / "xdg").exists()


def test_build_dir_cache_when_package_read_only(ops_copy, tmp_path, monkeypatch):
    """A read-only install builds under $XDG_CACHE_HOME, chosen once a
    process."""
    subprocess.run(["chmod", "-R", "a-w", str(ops_copy)], check=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    mod = _build_module(ops_copy)
    want = tmp_path / "xdg" / "gan_sass_tf_tpu_torch"
    assert mod.build_dir() == want and want.is_dir()
    assert mod.library_path().parent == want
    assert not (ops_copy / "_build").exists()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "other"))
    assert mod.build_dir() == want


def test_build_dir_raises_naming_both(ops_copy, tmp_path, monkeypatch):
    subprocess.run(["chmod", "-R", "a-w", str(ops_copy)], check=True)
    ro = tmp_path / "ro"
    ro.mkdir()
    subprocess.run(["chmod", "a-w", str(ro)], check=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(ro / "cache"))
    mod = _build_module(ops_copy)
    with pytest.raises(RuntimeError) as err:
        mod.build_dir()
    assert str(ops_copy / "_build") in str(err.value)
    assert str(ro / "cache" / "gan_sass_tf_tpu_torch") in str(err.value)
    assert not (ro / "cache").exists()


@pytest.fixture
def clean_registry():
    """Drop what a test registers, so that both packages' registries hold
    the same names again."""
    gens, discs = dict(registry._GENERATORS), dict(registry._DISCRIMINATORS)
    yield registry
    for table, saved in ((registry._GENERATORS, gens), (registry._DISCRIMINATORS, discs)):
        table.clear()
        table.update(saved)


def _cfg(**model):
    cfg = config.get_config("2src_toy_cpu")
    return cfg.replace(model=dataclasses.replace(cfg.model, **model))


class _TinyD(nn.Module):
    """A registered D that is not a ConvDiscriminator."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 4, 3)
        self.head = nn.Linear(4, 1)

    def forward(self, x):
        h = self.conv(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        return self.head(h)[:, 0]


def test_register_generator_builds_through_registry(clean_registry):
    @tmodels.register_generator("toy_again")
    def _toy_again(cfg):
        return registry._toy_generator(cfg)

    assert _toy_again is not None
    assert tmodels.list_generators() == ("bilstm", "conv", "toy", "toy_again")
    cfg = _cfg(generator="toy_again")
    g = tmodels.build_generator(cfg, "cpu", seed=3)
    ref = tmodels.build_generator(_cfg(generator="toy"), "cpu", seed=3)
    assert type(g) is type(ref) and not g.training
    for (k, a), (_, b) in zip(g.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), k
    feats = torch.zeros((1, 16, cfg.dsp.feature_dim))
    assert g(feats).shape[:2] == (1, cfg.data.num_sources)


def test_register_discriminator_generic_init(clean_registry):
    @tmodels.register_discriminator("tiny")
    def _tiny(cfg):
        return _TinyD()

    assert tmodels.list_discriminators() == ("conv", "patch", "tiny")
    d = tmodels.build_discriminator(_cfg(discriminator="tiny"), "cpu", seed=5)
    ref = init_params_(_TinyD(), torch.Generator().manual_seed(5))
    assert isinstance(d, _TinyD)
    for (k, a), (_, b) in zip(d.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), k
    assert not d.conv.bias.detach().any()
    assert d(torch.zeros((2, 16, 9, 2))).shape == (2,)


def test_registry_lists_are_sorted_tuples():
    assert tmodels.list_generators() == ("bilstm", "conv", "toy")
    assert tmodels.list_discriminators() == ("conv", "patch")
    assert tmodels.list_generators() == jmodels.list_generators()
    assert tmodels.list_discriminators() == jmodels.list_discriminators()


@pytest.mark.parametrize("field,build", [
    ("generator", "build_generator"), ("discriminator", "build_discriminator")])
def test_registry_key_error_matches_jax(field, build):
    cfg = _cfg(**{field: "nope"})
    with pytest.raises(KeyError) as ours:
        getattr(tmodels, build)(cfg, "cpu")
    with pytest.raises(KeyError) as ref:
        getattr(jmodels, build)(j_config.Config.from_json(cfg.to_json()))
    assert str(ours.value) == str(ref.value)
    assert f"unknown {field} 'nope'; have [" in str(ours.value)


@pytest.mark.parametrize("norm", ["spectral", "batch"])
def test_patch_discriminator_seeded_init(norm):
    """The patch builder's PatchDiscriminator carries the seeded init of
    a ConvDiscriminator(patch=True) (flax's draws from the seed's rng_d),
    draw for draw."""
    cfg = config.get_config("stream_v5e8")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, discriminator="patch",
                                                d_norm=norm))
    d = tmodels.build_discriminator(cfg, "cpu")
    assert type(d) is tmodels.PatchDiscriminator and d.patch
    m = cfg.model
    ref = tdisc.ConvDiscriminator(
        channels=tuple(m.d_channels), norm=m.d_norm, leak=m.leak, dropout=m.dropout,
        stem_stride=tuple(m.d_stem_stride), input_fold=m.d_input_fold, patch=True,
        dtype=getattr(torch, m.compute_dtype))
    flax_init_discriminator_(ref, registry.init_keys(0)[1])
    assert list(d.state_dict()) == list(ref.state_dict())
    for k, v in ref.state_dict().items():
        assert torch.equal(d.state_dict()[k], v), k
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 257, 2)).astype(np.float32))
    assert torch.equal(d(x), ref(x))


def _jax_exports(sub: str):
    """The JAX subpackage's __all__, or its top-level imports where it has
    none."""
    mod = importlib.import_module("gan_sass_tf_tpu" + (f".{sub}" if sub else ""))
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    tree = ast.parse(Path(mod.__file__).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Import):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
    return names


# The data package's exports beyond the JAX package's: the device bank,
# the bank's rows and the mixing on given draws (the plain parts of the
# step's batch), and jax.random's PRNGKey.  Every
# draw is the JAX package's (`data/threefry.py`); no other generator is
# exported.
DATA_PORT_ONLY = {"build_bank", "mix", "prng_key", "sample_bank", "take_rows"}


def test_data_exports_the_jax_names_and_the_device_draws_only():
    import gan_sass_tf_tpu.data as jdata
    import gan_sass_tf_tpu_torch.data as tdata

    assert set(tdata.__all__) == set(jdata.__all__) | DATA_PORT_ONLY
    assert not any(p.stem not in {"__init__", "corpus", "device_bank", "fixtures",
                                  "mixer", "synthetic", "threefry"}
                   for p in Path(tdata.__file__).parent.glob("*.py"))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_every_jax_name(sub):
    """Every name a JAX `__init__` exports is exported by the port's
    counterpart, or listed with its reason in NOT_PORTED, whose entries
    the port does lack and whose stand-ins it has."""
    port = importlib.import_module("gan_sass_tf_tpu_torch" + (f".{sub}" if sub else ""))
    names = _jax_exports(sub)
    assert names
    skipped = NOT_PORTED.get(sub, {})
    missing = [n for n in names if not hasattr(port, n) and n not in skipped]
    assert not missing, f"{sub or 'top level'}: {missing}"
    assert set(skipped) <= set(names)
    for name, reason in skipped.items():
        assert not hasattr(port, name), name
        stand_in = reason.split(": ", 1)[1].split(" ")[0]
        owner, _, attr = stand_in.partition(".")
        assert hasattr(getattr(port, owner), attr) if attr else hasattr(port, owner)
    if hasattr(port, "__all__"):
        assert all(hasattr(port, n) for n in port.__all__)

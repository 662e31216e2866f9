"""Model weights across frameworks: flax variable trees <-> port state_dicts.

The flax tree of `ConvUNetGenerator` (as nested numpy dicts) holds Conv_i,
ConvTranspose_i or PhaseConvTranspose_i and MaskHead_0 with Conv_i or
Dense_0, each with an HWIO (Dense: (in, out)) `kernel` and a `bias`; the
toy G's holds Dense_0, Dense_1 and MaskHead_0/Dense_0.  The tree of `BiLSTMGenerator` holds OptimizedLSTMCell_{2l}
(layer l forward) and OptimizedLSTMCell_{2l+1} (layer l backward), each
with per-gate kernels ii/if/ig/io (in, H), hi/hf/hg/ho (H, H) and the
biases of the h* gates, and MaskHead_0 with Conv_i (HWIO) and Dense_i
((in, out) kernels).  On disk a tree is a flat `.npz` whose keys are the
"/"-joined flax paths, e.g. "MaskHead_0/Conv_0/kernel" (written on the
JAX side with `jax.tree.map(np.asarray, params)` and flattened).

A discriminator's variables are {"params": {Conv_i, then Dense_0 (or the
patch D's 1x1 Conv_L), BatchNorm_j / GroupNorm_j}, "batch_stats": ...}:
the spectral-norm D keeps {SpectralNorm_i: {"<layer>/kernel/u",
"<layer>/kernel/sigma"}} there, SpectralNorm_i wrapping the i-th layer
(the head last), which is the port's buffer pair (u{i}, sigma{i}); the BN D
keeps {BatchNorm_j: {mean, var}}, the port's norms.j buffers.  Group- and
un-normalized Ds have no "batch_stats".

`flax_init_generator_` / `flax_init_discriminator_` draw a module's
initial weights as flax's `Module.init` does, in this layout, and move them
in through the converters.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from gan_sass_tf_tpu_torch.data import threefry
from gan_sass_tf_tpu_torch.models.discriminator import spectral_normalize

_GATES = "ifgo"          # flax's gate names, in torch.lstm's packing order
_LSTM = "OptimizedLSTMCell_"


def _index(flax_name: str) -> int:
    return int(flax_name.rpartition("_")[2])


def _tensor(a) -> torch.Tensor:
    # np.array copies: JAX hands out read-only buffers.
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _from_lstm_cell(leaf) -> Dict[str, torch.Tensor]:
    """flax OptimizedLSTMCell params -> LSTMCellParams' (gates packed along
    the rows; the h* biases are the one bias a gate)."""
    pack = lambda kind: np.concatenate(                 # noqa: E731
        [np.asarray(leaf[f"{kind}{g}"]["kernel"]) for g in _GATES], axis=1).T
    return {"weight_ih": _tensor(pack("i")), "weight_hh": _tensor(pack("h")),
            "bias": _tensor(np.concatenate([leaf[f"h{g}"]["bias"] for g in _GATES]))}


def _from_layer(flax_name: str, leaf) -> Dict[str, torch.Tensor]:
    """A flax Conv (HWIO -> OIHW), ConvTranspose or PhaseConvTranspose
    (HWIO -> (I, O, H, W) flipped in H and W, because lax.conv_transpose
    correlates with the unflipped kernel where conv_transpose2d flips it)
    or Dense ((in, out) -> (out, in))."""
    k = np.asarray(leaf["kernel"], np.float32)
    kind = flax_name.rpartition("_")[0]
    if kind in ("ConvTranspose", "PhaseConvTranspose"):
        w = np.flip(k.transpose(2, 3, 0, 1), axis=(2, 3))
    elif kind == "Dense":
        w = k.T
    else:
        w = k.transpose(3, 2, 0, 1)
    return {"weight": _tensor(w), "bias": _tensor(leaf["bias"])}


# flax module kind <-> the port's ModuleList of that kind.
_GROUPS = {"Conv": "convs", "ConvTranspose": "deconvs",
           "PhaseConvTranspose": "phase_deconvs", "Dense": "denses"}
_KINDS = {group: kind for kind, group in _GROUPS.items()}


def _module_name(flax_name: str) -> str:
    """The port's module of a top-level or MaskHead_0 flax layer."""
    kind, i = flax_name.rpartition("_")[0], _index(flax_name)
    if kind not in _GROUPS:
        raise KeyError(f"unexpected flax module {flax_name!r} in a generator")
    return f"{_GROUPS[kind]}.{i}"


def convert_generator_params(tree) -> Dict[str, torch.Tensor]:
    """Flax generator params (nested dicts of arrays, optionally under
    "params") -> the port's state_dict, for any generator (the tree's
    names say which layers it has)."""
    tree = tree.get("params", tree)
    sd = {}
    for name, leaf in tree.items():
        if name.startswith(_LSTM):
            layers = {f"cells.{_index(name)}": _from_lstm_cell(leaf)}
        elif name == "MaskHead_0":
            layers = {f"head.{_module_name(n)}": _from_layer(n, sub)
                      for n, sub in leaf.items()}
        else:
            layers = {_module_name(name): _from_layer(name, leaf)}
        for prefix, params in layers.items():
            sd.update({f"{prefix}.{k}": v for k, v in params.items()})
    return sd


def _flax_layer(module: str) -> str:
    """The port's module name -> its flax path (the inverse of
    `_module_name`, MaskHead_0 included)."""
    prefix = ""
    if module.startswith("head."):
        prefix, module = "MaskHead_0/", module[len("head."):]
    group, i = module.split(".")
    return f"{prefix}{_KINDS[group]}_{i}"


def generator_params_to_flax(state_dict) -> Dict[str, np.ndarray]:
    """Inverse of `convert_generator_params`, flattened to "/"-joined keys
    (the `.npz` layout)."""
    flat = {}
    for key, t in state_dict.items():
        a = t.detach().float().cpu().numpy().copy()   # no alias of a live tensor
        module, _, leaf = key.rpartition(".")
        if module.startswith("cells."):
            cell = f"{_LSTM}{module.split('.')[1]}"
            kind = "i" if leaf == "weight_ih" else "h"
            name = "bias" if leaf == "bias" else "kernel"
            for g, part in zip(_GATES, np.split(a, 4, axis=0)):   # 1-D: .T is a no-op
                flat[f"{cell}/{kind}{g}/{name}"] = np.ascontiguousarray(part.T)
            continue
        path = _flax_layer(module)
        if leaf == "weight":
            if a.ndim == 2:                                  # Dense
                a = a.T
            elif "ConvTranspose_" in path:                   # Phase... too
                a = np.flip(a, axis=(2, 3)).transpose(2, 3, 0, 1)
            else:
                a = a.transpose(2, 3, 1, 0)
            leaf = "kernel"
        flat[f"{path}/{leaf}"] = np.ascontiguousarray(a)
    return flat


def save_flax_npz(path: str, state_dict) -> None:
    np.savez(path, **generator_params_to_flax(state_dict))


def _nest(flat) -> dict:
    """Flat "/"-keyed leaves -> nested dicts."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, name = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def load_flax_npz(path: str) -> dict:
    """Flat "/"-keyed `.npz` -> nested dict of numpy arrays."""
    with np.load(path) as z:
        return _nest({key: z[key] for key in z.files})


def load_generator(cfg, tree, device) -> torch.nn.Module:
    """Generator for `cfg` carrying the flax params `tree`, on `device`."""
    from gan_sass_tf_tpu_torch.models.registry import build_generator

    g = build_generator(cfg, device)
    g.load_state_dict(convert_generator_params(tree))
    return g


def _d_layers(params) -> list:
    """Flax D layer names in SpectralNorm order: Conv_0.., then the head
    (Dense_0, or the patch D's last Conv)."""
    convs = sorted((n for n in params if n.startswith("Conv_")),
                   key=lambda n: int(n.rpartition("_")[2]))
    return convs + (["Dense_0"] if "Dense_0" in params else [])


def convert_discriminator_variables(variables) -> Dict[str, torch.Tensor]:
    """Flax D variables {"params"[, "batch_stats"]} (nested numpy dicts) ->
    the port's state_dict, buffers included.  Conv kernels HWIO -> OIHW,
    the Dense (C, 1) kernel -> Linear (1, C); BatchNorm_j / GroupNorm_j
    scale and bias (and BN's mean and var) -> norms.j; SpectralNorm_i's
    u and sigma -> u{i}, sigma{i}."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    names = _d_layers(params)
    sd = {}
    for i, name in enumerate(names):
        leaf = params[name]
        k = np.asarray(leaf["kernel"], np.float32)
        prefix = "head" if i == len(names) - 1 else f"convs.{i}"
        w = k.T if name == "Dense_0" else k.transpose(3, 2, 0, 1)
        sd[f"{prefix}.weight"] = _tensor(w)
        sd[f"{prefix}.bias"] = _tensor(leaf["bias"])
        sn = stats.get(f"SpectralNorm_{i}")
        if sn is not None:
            sd[f"u{i}"] = _tensor(sn[f"{name}/kernel/u"])
            sd[f"sigma{i}"] = _tensor(sn[f"{name}/kernel/sigma"])
    for name, leaf in params.items():
        if name.startswith(("BatchNorm_", "GroupNorm_")):
            j = _index(name)
            sd[f"norms.{j}.scale"] = _tensor(leaf["scale"])
            sd[f"norms.{j}.bias"] = _tensor(leaf["bias"])
            if name in stats:
                sd[f"norms.{j}.mean"] = _tensor(stats[name]["mean"])
                sd[f"norms.{j}.var"] = _tensor(stats[name]["var"])
    return sd


def discriminator_variables_to_flax(state_dict) -> Dict[str, dict]:
    """Inverse of `convert_discriminator_variables`: nested numpy dicts
    {"params"[, "batch_stats"]} in the flax layout ("batch_stats" only
    where flax has it: spectral and batch norms)."""
    a = {k: t.detach().float().cpu().numpy().copy() for k, t in state_dict.items()}
    n_conv = sum(1 for k in a if k.startswith("convs.") and k.endswith(".weight"))
    patch = a["head.weight"].ndim == 4
    params, stats = {}, {}
    for i in range(n_conv + 1):
        head = i == n_conv
        prefix = "head" if head else f"convs.{i}"
        name = "Dense_0" if head and not patch else f"Conv_{i}"
        w = a[f"{prefix}.weight"]
        params[name] = {
            "kernel": np.ascontiguousarray(w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)),
            "bias": a[f"{prefix}.bias"]}
        if f"u{i}" in a:
            stats[f"SpectralNorm_{i}"] = {f"{name}/kernel/u": a[f"u{i}"],
                                          f"{name}/kernel/sigma": a[f"sigma{i}"]}
    for j in range(n_conv - 1):
        if f"norms.{j}.scale" not in a:
            break
        bn = f"norms.{j}.mean" in a
        name = f"{'BatchNorm' if bn else 'GroupNorm'}_{j}"
        params[name] = {"scale": a[f"norms.{j}.scale"], "bias": a[f"norms.{j}.bias"]}
        if bn:
            stats[name] = {"mean": a[f"norms.{j}.mean"], "var": a[f"norms.{j}.var"]}
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def load_discriminator(cfg, variables, device) -> torch.nn.Module:
    """Discriminator for `cfg` carrying the flax variables (params and
    spectral-norm state), on `device`."""
    from gan_sass_tf_tpu_torch.models.registry import build_discriminator

    d = build_discriminator(cfg, device)
    d.load_state_dict(convert_discriminator_variables(variables))
    return d


# ---------------------------------------------------------------------------
# Initial weights as flax draws them.
# ---------------------------------------------------------------------------

def lecun_normals(draws) -> list:
    """flax's default kernel init, `variance_scaling(1, "fan_in",
    "truncated_normal")`, for each (key, shape) of `draws`: a normal
    truncated at ±2, times the float32 sqrt(1/fan_in) / 0.8796 (the
    truncated normal's std), fan_in the product of all but the last axis
    (HWIO or (in, out))."""
    out = []
    for (_, shape), z in zip(draws, threefry.normals(draws, -2.0, 2.0)):
        var = torch.tensor(1.0 / math.prod(shape[:-1]), dtype=torch.float32)
        out.append(z * (var.sqrt() / torch.tensor(0.87962566103423978,
                                                  dtype=torch.float32)))
    return out


def orthogonal(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.nn.initializers.orthogonal()` (an LSTM's recurrent kernels): Q
    of the QR of a normal (rows >= columns), its columns' signs those of
    diag(R), transposed back where the kernel is wide."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    z = threefry.normal(key, (max(n_rows, n_cols), min(n_rows, n_cols)))
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q.T if n_rows < n_cols else q).reshape(shape)


def _param_key(key: torch.Tensor, path) -> torch.Tensor:
    """The key flax's init hands the first parameter a module makes (its
    kernel, or a norm's scale): the module path's names and the counter 1."""
    return threefry.fold_in_static(key, (*path, 1))


def flax_init_generator_(g: torch.nn.Module, key: torch.Tensor) -> torch.nn.Module:
    """G's weights in place as `g.init(key, ...)` of the flax G draws them
    (`key` the (2,) rng_g on the CPU): each kernel lecun-normal under its
    module's key, an LSTM cell's recurrent (h*) kernels orthogonal, every
    bias zero."""
    flat = generator_params_to_flax(g.state_dict())
    lecun = {}
    for name, a in flat.items():
        *path, leaf = name.split("/")
        if leaf == "bias":
            flat[name] = np.zeros_like(a)
        elif path[0].startswith(_LSTM) and path[-1][0] == "h":
            flat[name] = orthogonal(_param_key(key, path), a.shape).numpy()
        elif leaf == "kernel":
            lecun[name] = (_param_key(key, path), a.shape)
    for name, w in zip(lecun, lecun_normals(list(lecun.values()))):
        flat[name] = w.numpy()
    with torch.no_grad():
        g.load_state_dict(convert_generator_params(_nest(flat)))
    return g


def flax_init_discriminator_(d: torch.nn.Module, key: torch.Tensor) -> torch.nn.Module:
    """D's weights and state in place as `d.init(key, ...)` of the flax D
    makes them (`key` the (2,) rng_d on the CPU): lecun-normal kernels, zero
    biases, norms at scale 1 (BN: mean 0, var 1), and each SpectralNorm_i's
    u a standard normal under its own module key, sigma 1.  flax's init
    stores a spectral-normalized layer's kernel as it comes out of the
    wrapper: divided by the sigma of one power iteration from that u."""
    v = discriminator_variables_to_flax(d.state_dict())
    params, stats = v["params"], v.get("batch_stats", {})
    for leaf in list(params.values()) + list(stats.values()):
        for k, a in leaf.items():
            kind = k.rpartition("/")[2]
            leaf[k] = np.full_like(a, 1.0 if kind in ("scale", "var", "sigma") else 0.0)
    kernels = [n for n in params if "kernel" in params[n]]
    for n, w in zip(kernels, lecun_normals(
            [(_param_key(key, (n,)), params[n]["kernel"].shape) for n in kernels])):
        params[n]["kernel"] = w
    us = [(sn, k) for sn, leaf in stats.items() for k in leaf if k.endswith("/u")]
    for (sn, k), u in zip(us, threefry.normals(
            [(_param_key(key, (sn,)), stats[sn][k].shape) for sn, k in us])):
        layer = params[k.partition("/")[0]]
        stats[sn][k] = u
        w = layer["kernel"]
        layer["kernel"] = spectral_normalize(w.reshape(-1, w.shape[-1]), u)[0].reshape(w.shape)
    with torch.no_grad():
        d.load_state_dict(convert_discriminator_variables(v))
    return d

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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gan_sass_tf_tpu_torch.models.registry import build_discriminator, build_generator

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


def load_flax_npz(path: str) -> dict:
    """Flat "/"-keyed `.npz` -> nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def load_generator(cfg, tree, device) -> torch.nn.Module:
    """Generator for `cfg` carrying the flax params `tree`, on `device`."""
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
    d = build_discriminator(cfg, device)
    d.load_state_dict(convert_discriminator_variables(variables))
    return d

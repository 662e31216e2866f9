"""Model weights across frameworks: flax variable trees <-> port state_dicts.

The flax tree of `ConvUNetGenerator` (as nested numpy dicts) holds Conv_i,
ConvTranspose_i and MaskHead_0/Conv_0, each with an HWIO `kernel` and a
`bias`.  On disk it is a flat `.npz` whose keys are the "/"-joined flax
paths, e.g. "MaskHead_0/Conv_0/kernel" (written on the JAX side with
`jax.tree.map(np.asarray, params)` and flattened).

The spectral-norm `ConvDiscriminator`'s variables are {"params": {Conv_i,
Dense_0}, "batch_stats": {SpectralNorm_i: {"<layer>/kernel/u",
"<layer>/kernel/sigma"}}}; SpectralNorm_i wraps the i-th layer (the Dense
head last), which is the port's buffer pair (u{i}, sigma{i}).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gan_sass_tf_tpu_torch.models.registry import build_discriminator, build_generator


def _module_name(flax_name: str) -> str:
    kind, _, idx = flax_name.rpartition("_")
    if kind == "Conv":
        return f"convs.{int(idx)}"
    if kind == "ConvTranspose":
        return f"deconvs.{int(idx)}"
    raise KeyError(f"unexpected flax module {flax_name!r} in a conv generator")


def convert_generator_params(tree) -> Dict[str, torch.Tensor]:
    """Flax generator params (nested dicts of arrays, optionally under
    "params") -> the port's state_dict.  Conv kernels HWIO -> OIHW;
    ConvTranspose kernels HWIO -> (I, O, H, W) flipped in H and W, because
    lax.conv_transpose correlates with the unflipped kernel where
    conv_transpose2d flips it."""
    tree = tree.get("params", tree)
    sd = {}
    for name, leaf in tree.items():
        if name == "MaskHead_0":
            prefix, leaf = "head.conv", leaf["Conv_0"]
        else:
            prefix = _module_name(name)
        k = np.asarray(leaf["kernel"], np.float32)
        if prefix.startswith("deconvs"):
            w = np.flip(k.transpose(2, 3, 0, 1), axis=(2, 3))
        else:
            w = k.transpose(3, 2, 0, 1)
        # np.array copies: JAX hands out read-only buffers.
        sd[f"{prefix}.weight"] = torch.from_numpy(np.array(w, order="C"))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
    return sd


def generator_params_to_flax(state_dict) -> Dict[str, np.ndarray]:
    """Inverse of `convert_generator_params`, flattened to "/"-joined keys
    (the `.npz` layout)."""
    flat = {}
    for key, t in state_dict.items():
        a = t.detach().float().cpu().numpy().copy()   # no alias of a live tensor
        if key.startswith("head.conv."):
            path, leaf = "MaskHead_0/Conv_0", key.rsplit(".", 1)[1]
        else:
            group, idx, leaf = key.split(".")
            path = f"{'Conv' if group == 'convs' else 'ConvTranspose'}_{idx}"
        if leaf == "weight":
            if path.startswith("ConvTranspose"):
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
    """Flax D layer names in SpectralNorm order: Conv_0.., then Dense_0."""
    convs = sorted((n for n in params if n.startswith("Conv_")),
                   key=lambda n: int(n.rpartition("_")[2]))
    return convs + ["Dense_0"]


def convert_discriminator_variables(variables) -> Dict[str, torch.Tensor]:
    """Flax D variables {"params", "batch_stats"} (nested numpy dicts) ->
    the port's state_dict, buffers included.  Conv kernels HWIO -> OIHW,
    the Dense (C, 1) kernel -> Linear (1, C)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for i, name in enumerate(_d_layers(params)):
        leaf = params[name]
        k = np.asarray(leaf["kernel"], np.float32)
        prefix = "head" if name == "Dense_0" else f"convs.{i}"
        w = k.T if name == "Dense_0" else k.transpose(3, 2, 0, 1)
        sd[f"{prefix}.weight"] = torch.from_numpy(np.array(w, order="C"))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
        sn = stats[f"SpectralNorm_{i}"]
        sd[f"u{i}"] = torch.from_numpy(np.array(sn[f"{name}/kernel/u"], np.float32))
        sd[f"sigma{i}"] = torch.from_numpy(np.array(sn[f"{name}/kernel/sigma"],
                                                    np.float32))
    return sd


def discriminator_variables_to_flax(state_dict) -> Dict[str, dict]:
    """Inverse of `convert_discriminator_variables`: nested numpy dicts
    {"params": ..., "batch_stats": ...} in the flax layout."""
    a = {k: t.detach().float().cpu().numpy().copy() for k, t in state_dict.items()}
    n_conv = sum(1 for k in a if k.startswith("convs.") and k.endswith(".weight"))
    params, stats = {}, {}
    for i in range(n_conv + 1):
        head = i == n_conv
        name, prefix = ("Dense_0", "head") if head else (f"Conv_{i}", f"convs.{i}")
        w = a[f"{prefix}.weight"]
        params[name] = {
            "kernel": np.ascontiguousarray(w.T if head else w.transpose(2, 3, 1, 0)),
            "bias": a[f"{prefix}.bias"]}
        stats[f"SpectralNorm_{i}"] = {f"{name}/kernel/u": a[f"u{i}"],
                                      f"{name}/kernel/sigma": a[f"sigma{i}"]}
    return {"params": params, "batch_stats": stats}


def load_discriminator(cfg, variables, device) -> torch.nn.Module:
    """Discriminator for `cfg` carrying the flax variables (params and
    spectral-norm state), on `device`."""
    d = build_discriminator(cfg, device)
    d.load_state_dict(convert_discriminator_variables(variables))
    return d

"""Generator weights across frameworks: flax param tree <-> port state_dict.

The flax tree of `ConvUNetGenerator` (as nested numpy dicts) holds Conv_i,
ConvTranspose_i and MaskHead_0/Conv_0, each with an HWIO `kernel` and a
`bias`.  On disk it is a flat `.npz` whose keys are the "/"-joined flax
paths, e.g. "MaskHead_0/Conv_0/kernel" (written on the JAX side with
`jax.tree.map(np.asarray, params)` and flattened).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gan_sass_tf_tpu_torch.models.registry import build_generator


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
        a = t.detach().float().cpu().numpy()
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

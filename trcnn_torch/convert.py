"""Weight bridge between the JAX package's flax parameter tree and the
port's ``state_dict``.

The flax tree is taken as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.  Module
paths map one to one (``extractor/conv1_1/kernel`` <->
``extractor.conv1_1.weight``):

- conv kernels HWIO <-> OIHW (ResNet-101's convolutions have no bias);
- dense kernels (in, out) <-> ``nn.Linear`` weights (out, in);
- biases, and the FrozenBN leaves ``scale``/``bias``/``mean``/``var``
  (``extractor/res3/block1/bn1/scale`` <-> ``extractor.res3.block1.bn1.scale``),
  as they are.

fc6's rows keep the NHWC (h, w, c) flatten order, which is also the port's
flatten order, and the RPN's channel order is kept as it is.

The optimizer's momentum crosses through the same two functions: optax's
``trace`` leaf tree (``TraceState.trace``, shaped like the parameter tree)
maps to the port's momentum buffers (``CaffeSGD.state_dict()["momentum"]``,
keyed like the parameters) and back, with the same layout maps.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


# leaves that keep their name and layout: biases and the FrozenBN leaves
_AS_IS = ("bias", "scale", "mean", "var")


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': {...}} (or the inner dict) of numpy arrays -> state_dict."""
    params = tree.get("params", tree)
    out = {}
    for path, leaf in _walk(params):
        arr = np.asarray(leaf)
        key = ".".join(path[:-1])
        if path[-1] == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            out[key + ".weight"] = torch.tensor(arr)
        elif path[-1] in _AS_IS:
            out[key + "." + path[-1]] = torch.tensor(arr)
        else:
            raise ValueError(f"unexpected leaf {'/'.join(path)}")
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """state_dict -> {'params': nested dict of numpy arrays}."""
    root: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            name = "kernel"
        elif leaf in _AS_IS:
            name = leaf
        else:
            raise ValueError(f"unexpected state_dict entry {key}")
        node = root
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.array(arr, order="C")    # a copy: the port updates in place
    return {"params": root}


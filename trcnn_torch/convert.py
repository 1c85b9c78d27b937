"""Weight bridge between the JAX package's flax parameter tree and the
port's ``state_dict``.

The flax tree is taken as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.  Module
paths map one to one (``extractor/conv1_1/kernel`` <->
``extractor.conv1_1.weight``):

- conv kernels HWIO <-> OIHW;
- dense kernels (in, out) <-> ``nn.Linear`` weights (out, in);
- biases as they are.

fc6's rows keep the NHWC (h, w, c) flatten order, which is also the port's
flatten order, and the RPN's channel order is kept as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


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
        elif path[-1] == "bias":
            out[key + ".bias"] = torch.tensor(arr)
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
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"unexpected state_dict entry {key}")
        node = root
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": root}

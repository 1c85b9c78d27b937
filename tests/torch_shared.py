"""JAX reference fixtures built once per test run and shared by the port's
test modules across pytest-xdist's worker processes.

The first caller builds the fixture and saves its arrays in the run's
shared temporary directory (the parent of each worker's base temp
directory); every other caller, in any worker, waits on a file lock and
loads them.  The arrays are JAX's output computed in this run, not a
stored golden.
"""

import fcntl
import os

import numpy as np


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree(flat):
    tree = {}
    for k, v in flat.items():
        *mods, leaf = k.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def shared_arrays(tmp_path_factory, name, build):
    """``build()``'s dict of arrays and nested dicts of arrays (keys without
    "/"), built once per test run: by the first caller, loaded from the
    run's shared temporary directory by the others."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.npz"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            out = build()
            flat = {"/".join(k): np.asarray(v) for k, v in _leaves(out)}
            tmp = base / f"{name}.{os.getpid()}.npz"
            np.savez(tmp, **flat)
            os.replace(tmp, path)
            return out
    with np.load(path) as f:
        return _tree({k: f[k] for k in f.files})


def _detect_fixture(tmp_path_factory, module):
    """``module._fixture()`` (cfg, model, params, images, im_info) of a
    detect cross-implementation test module, shared by the run."""
    import jax.numpy as jnp

    from trcnn.models import make_model

    def build():
        _, _, params, images, im_info = module._fixture()
        return {"params": params, "images": images, "im_info": im_info}

    d = shared_arrays(tmp_path_factory, module.__name__.rsplit(".", 1)[-1], build)
    cfg = module._cfg()
    return cfg, make_model(cfg, dtype=jnp.float32), d["params"], d["images"], d["im_info"]


def vgg_detect_fixture(tmp_path_factory):
    """tests/test_cross_impl.py's calibrated VGG-16 fixture."""
    from tests import test_cross_impl

    return _detect_fixture(tmp_path_factory, test_cross_impl)


def r101_fixture(tmp_path_factory):
    """tests/test_cross_impl_resnet.py's ResNet-101 fixture."""
    from tests import test_cross_impl_resnet

    return _detect_fixture(tmp_path_factory, test_cross_impl_resnet)


def vgg_train_fixture(tmp_path_factory):
    """tests/test_cross_impl_train.py's ``_fixture()`` (cfg, model, params,
    images, im_info, (gt_boxes, gt_labels, gt_valid)), shared by the run."""
    import jax.numpy as jnp

    from tests import test_cross_impl_train
    from trcnn.models import make_model

    def build():
        _, _, params, images, im_info, (gtb, gtl, gtv) = test_cross_impl_train._fixture()
        return {"params": params, "images": images, "im_info": im_info,
                "gt": {"boxes": gtb, "labels": gtl, "valid": gtv}}

    d = shared_arrays(tmp_path_factory, "vgg_train_fixture", build)
    cfg = test_cross_impl_train._cfg()
    gt = d["gt"]
    return (cfg, make_model(cfg, dtype=jnp.float32), d["params"], d["images"], d["im_info"],
            (gt["boxes"], gt["labels"], gt["valid"]))

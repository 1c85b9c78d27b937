"""Weight conversion between the reference's Chainer npz and the flax-side
flat npz, the port's counterpart of ``scripts/convert_weights.py``:

    # import the reference weights into a flat npz of the flax tree
    python -m trcnn_torch.cli.convert --src VGG16_faster_rcnn_final.npz \
        --dst flax_params.npz --direction to_flax

    # export trained parameters back to the reference's npz layout
    python -m trcnn_torch.cli.convert --src flax_params.npz \
        --dst chainer.npz --direction to_chainer

The flax side is the JAX script's container: one npz whose keys are the
tree's paths joined by '/' (``params/extractor/conv1_1/kernel``, HWIO
kernels, (in, out) dense kernels), so that a file moves between the two
packages; :func:`load_flax_npz` reads it and
``trcnn_torch.convert.flax_to_state_dict`` turns it into the port's
state_dict.  The conversion is numpy on the host: there is no device to
choose.  ``--no_bbox_normalize`` and ``--loose`` mean what they mean in
the JAX script: the importer's ``normalize_bbox_pred=False`` and
``strict=False``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np

from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.convert import flax_to_state_dict, state_dict_to_flax
from trcnn_torch.convert_chainer import export_chainer_npz, import_chainer_npz


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict -> {'/'-joined path: array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat) -> Dict[str, Any]:
    """The inverse of :func:`flatten`."""
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_flax_npz(path: str) -> Dict[str, Any]:
    """A flat flax npz -> the nested tree ({'params': {...}})."""
    return unflatten(dict(np.load(path)))


def chainer_to_flat(src, cfg: FasterRCNNConfig, normalize_bbox_pred: bool = True,
                    strict: bool = True) -> Dict[str, np.ndarray]:
    """A Chainer npz (path or dict) -> the flat flax npz's arrays."""
    sd = import_chainer_npz(src, cfg, normalize_bbox_pred=normalize_bbox_pred, strict=strict)
    return flatten(state_dict_to_flax(sd))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--direction", required=True, choices=["to_flax", "to_chainer"])
    ap.add_argument("--num_classes", type=int, default=21)
    ap.add_argument("--head_hidden", type=int, default=4096)
    ap.add_argument("--no_bbox_normalize", action="store_true",
                    help="skip the bbox_pred normalization fix-up "
                         "(for trees that never baked unnormalization in)")
    ap.add_argument("--loose", action="store_true",
                    help="skip missing tensors instead of erroring")
    args = ap.parse_args(argv)

    cfg = FasterRCNNConfig(num_classes=args.num_classes, head_hidden=args.head_hidden)
    if args.direction == "to_flax":
        flat = chainer_to_flat(args.src, cfg, normalize_bbox_pred=not args.no_bbox_normalize,
                               strict=not args.loose)
        np.savez(args.dst, **flat)
        print(f"wrote {len(flat)} tensors to {args.dst}")
    else:
        export_chainer_npz(flax_to_state_dict(load_flax_npz(args.src)), args.dst, cfg)
        print(f"wrote chainer-layout npz to {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

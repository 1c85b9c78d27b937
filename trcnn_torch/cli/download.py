"""Pretrained-weight fetcher, the port's counterpart of
``scripts/download_weights.py``.

The canonical sources of the reference's weights:

  * detection weights (Chainer npz, converted from the original Caffe
    ``VGG16_faster_rcnn_final.caffemodel`` of rbgirshick/py-faster-rcnn):
    the mitmul/chainer-faster-rcnn release assets;
  * the ImageNet VGG-16 trunk for a training warm start: the Chainer
    VGG16Layers pretrained npz (``vgg16.npz``).

This script fetches nothing.  Given a file already on disk it converts it,
at the VOC config and with missing layers skipped, into the flat flax npz
of :mod:`trcnn_torch.cli.convert`:

    python -m trcnn_torch.cli.download --file VGG16_faster_rcnn_final.npz \
        --out flax_params.npz

Without ``--file`` it prints these sources and exits with 1.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from trcnn_torch.cli.convert import chainer_to_flat
from trcnn_torch.config import voc_config


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--file", default=None, help="already-downloaded chainer npz to convert")
    ap.add_argument("--out", default="flax_params.npz")
    args = ap.parse_args(argv)

    if not args.file:
        print(__doc__)
        print("no --file given and nothing is fetched; download the npz elsewhere and pass "
              "it with --file.")
        return 1
    if not os.path.exists(args.file):
        print(f"{args.file} not found", file=sys.stderr)
        return 1
    np.savez(args.out, **chainer_to_flat(args.file, voc_config(), strict=False))
    print(f"converted {args.file} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

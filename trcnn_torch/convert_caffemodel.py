"""Caffe ``.caffemodel`` -> the port's ``state_dict``: the port's own copy of
``trcnn/convert/caffemodel.py`` (pure Python and numpy; no caffe, no
protobuf package, no JAX).

py-faster-rcnn's ``VGG16_faster_rcnn_final.caffemodel`` is a serialized
``NetParameter``.  A minimal protobuf wire-format parser takes each layer's
blobs from either encoding, the modern ``layer`` (field 100,
LayerParameter) and the pre-2015 ``layers`` (field 2, V1LayerParameter),
renames them into the Chainer npz key space and hands them to
:func:`trcnn_torch.convert_chainer.import_chainer_npz`, so every layout
fix-up (OIHW -> HWIO, the fc6 flatten order, the bbox_pred normalisation)
is the npz path's.

Wire subset handled (proto2):
  NetParameter:     layer = 100 (LEN), layers = 2 (LEN)
  LayerParameter:   name = 1 (LEN), blobs = 7 (LEN)
  V1LayerParameter: name = 1 (LEN), blobs = 6 (LEN)
  BlobProto:        num/channels/height/width = 1..4 (VARINT),
                    data = 5 (packed f32 LEN, or repeated 32-bit f32),
                    shape = 7 (LEN -> BlobShape.dim = 1, varint or packed)
Unknown fields are skipped by the wire rules, so real checkpoints with
phase, loss_weight or param blocks parse.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.convert_chainer import import_chainer_npz

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow (corrupt caffemodel?)")


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, payload) over one message: an int for a
    varint, a memoryview otherwise."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == _VARINT:
            val, pos = _read_varint(buf, pos)
            yield fnum, wtype, val
        elif wtype == _I64:
            yield fnum, wtype, buf[pos:pos + 8]
            pos += 8
        elif wtype == _LEN:
            ln, pos = _read_varint(buf, pos)
            yield fnum, wtype, buf[pos:pos + ln]
            pos += ln
        elif wtype == _I32:
            yield fnum, wtype, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")


def _parse_blob(buf: memoryview) -> Optional[np.ndarray]:
    dims_legacy = {}
    shape: Optional[List[int]] = None
    data_chunks: List[np.ndarray] = []
    for fnum, wtype, payload in _fields(buf):
        if fnum in (1, 2, 3, 4) and wtype == _VARINT:
            dims_legacy[fnum] = payload
        elif fnum == 5:
            if wtype == _LEN:                      # packed float data
                data_chunks.append(np.frombuffer(payload, dtype="<f4"))
            elif wtype == _I32:                    # one unpacked float
                data_chunks.append(np.asarray([struct.unpack("<f", payload)[0]], np.float32))
        elif fnum == 7 and wtype == _LEN:          # BlobShape
            shape = []
            for sfn, swt, sp in _fields(payload):
                if sfn != 1:
                    continue
                if swt == _VARINT:
                    shape.append(sp)
                elif swt == _LEN:                  # packed dims
                    pos = 0
                    while pos < len(sp):
                        v, pos = _read_varint(sp, pos)
                        shape.append(v)
    if not data_chunks:
        return None
    data = np.concatenate(data_chunks)
    if shape is None and dims_legacy:
        shape = [dims_legacy.get(i, 1) for i in (1, 2, 3, 4)]
        while len(shape) > 1 and shape[0] == 1:    # legacy blobs pad with 1s
            shape = shape[1:]
    if shape:
        data = data.reshape(shape)
    return data


def parse_caffemodel(path_or_bytes) -> Dict[str, List[np.ndarray]]:
    """NetParameter -> {layer name: [blob0 (W), blob1 (b), ...]}."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        raw = memoryview(bytes(path_or_bytes))
    else:
        with open(path_or_bytes, "rb") as f:
            raw = memoryview(f.read())
    layers: Dict[str, List[np.ndarray]] = {}
    for fnum, wtype, payload in _fields(raw):
        if wtype != _LEN or fnum not in (2, 100):
            continue
        blobs_field = 6 if fnum == 2 else 7        # V1LayerParameter vs LayerParameter
        name = None
        blobs: List[np.ndarray] = []
        for lfn, lwt, lp in _fields(payload):
            if lfn == 1 and lwt == _LEN:
                name = bytes(lp).decode("utf-8", "replace")
            elif lfn == blobs_field and lwt == _LEN:
                blob = _parse_blob(lp)
                if blob is not None:
                    blobs.append(blob)
        if name and blobs:
            layers[name] = blobs
    return layers


def caffemodel_to_npz_dict(path_or_bytes) -> Dict[str, np.ndarray]:
    """The parsed layers in the Chainer npz key space (``<name>/W``,
    ``<name>/b``; '/' in a caffe name becomes '_': ``rpn_conv/3x3`` ->
    ``rpn_conv_3x3``)."""
    out: Dict[str, np.ndarray] = {}
    for name, blobs in parse_caffemodel(path_or_bytes).items():
        key = name.replace("/", "_")
        out[f"{key}/W"] = blobs[0].astype(np.float32)
        if len(blobs) >= 2:
            out[f"{key}/b"] = blobs[1].astype(np.float32)
    return out


def import_caffemodel(path_or_bytes, cfg: FasterRCNNConfig = FasterRCNNConfig(),
                      normalize_bbox_pred: bool = True, strict: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """``VGG16_faster_rcnn_final.caffemodel`` (or an ImageNet VGG-16
    caffemodel, with strict=False) -> the port's state_dict entries.  Caffe
    blobs are OIHW / (out, in) for BGR 0-255 input minus the pixel means,
    the Chainer conventions, so the npz importer does all the layout work."""
    return import_chainer_npz(caffemodel_to_npz_dict(path_or_bytes), cfg,
                              normalize_bbox_pred=normalize_bbox_pred, strict=strict)

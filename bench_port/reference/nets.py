"""The networks of Faster R-CNN in plain float32 PyTorch: VGG-16 and
ResNet-101-C4 trunks, the RPN, the fc6/fc7 and res5 heads, Caffe's RoI max
pool and RoIAlign, from a flat dict of weights.

A translation of the repository's independent numpy pipelines
(``tests/cross_impl_reference.py``, ``tests/cross_impl_resnet_reference.py``)
into torch operations, so that it runs at full size on the card after a
benchmark's window.  It imports neither the JAX package nor the port, and
takes nothing the port made: the weights are the benchmark's own
(:mod:`bench_port.weights`), keyed by the names of the layers below.

Layouts: images and feature maps NHWC at the boundaries, NCHW inside;
convolution weights OIHW, dense weights (out, in); a RoI crop flattens in
(h, w, c) order into fc6.  Every convolution and product runs in float32
with TF32 off (:func:`float32_exact`).  ``quant="fp8"`` rounds the
operands of every convolution and product to float8 e4m3 with one scale
per tensor before the float32 arithmetic, in the forward and in the
backward (the incoming gradient, and the gradients passed back): the
control that a comparison has to reject.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

VGG_BLOCKS = (("conv1", 2, 64), ("conv2", 2, 128), ("conv3", 3, 256), ("conv4", 3, 512),
              ("conv5", 3, 512))
VGG_FROZEN = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")
# ResNet-101-C4: (stage, blocks, channels, stride); res5 is the RoI head's
RES_STAGES = (("res2", 3, 64, 1), ("res3", 4, 128, 2), ("res4", 23, 256, 2))
RES5 = ("res5", 3, 512, 2)
R101_FROZEN = ("conv1", "bn1", "res2")
# the trunk's output channels, which the RPN, the pool and the head take
FEAT_CHANNELS = {"vgg16": 512, "resnet101": 1024}
BN_LEAVES = ("scale", "bias", "mean", "var")
BN_EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """A product's operand in fp8: rounded on the way in, and its gradient
    rounded on the way back."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


class _Fp8Grad(torch.autograd.Function):
    """A product's result: unchanged on the way in, its gradient (the
    backward products' operand) rounded to fp8 on the way back."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


fp8 = _Fp8.apply
fp8_grad = _Fp8Grad.apply


class Net:
    """The float32 forward of one configuration over weights ``w``.
    ``quant``: "none", or "fp8" for the control.  Each FrozenBN named in
    ``fit_bn`` first takes the mean and variance of its input as its
    statistics (in place in ``w``)."""

    def __init__(self, w: Weights, backbone: str, num_classes: int, pool_size: int,
                 quant: str = "none"):
        if quant not in ("none", "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.w, self.backbone, self.num_classes = w, backbone, num_classes
        self.pool_size, self.quant = pool_size, quant
        self.fit_bn: frozenset = frozenset()

    @classmethod
    def for_config(cls, w: Weights, cfg, quant: str = "none") -> "Net":
        return cls(w, cfg.backbone, cfg.num_classes, crop_size(cfg), quant)

    # ---- primitives
    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x) if self.quant == "fp8" else x

    def _qy(self, y: torch.Tensor) -> torch.Tensor:
        return fp8_grad(y) if self.quant == "fp8" and y.requires_grad else y

    def conv(self, x: torch.Tensor, name: str, stride: int = 1, relu: bool = False
             ) -> torch.Tensor:
        k = self.w[f"{name}.weight"]
        y = self._qy(F.conv2d(self._q(x), self._q(k), stride=stride, padding=k.shape[-1] // 2))
        bias = self.w.get(f"{name}.bias")
        if bias is not None:
            y = y + bias.view(1, -1, 1, 1)
        return torch.relu(y) if relu else y

    def dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self._qy(self._q(x) @ self._q(self.w[f"{name}.weight"]).t()) + self.w[f"{name}.bias"]

    def frozen_bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if name in self.fit_bn:         # statistics of this input, as training leaves them
            self.w[f"{name}.mean"].copy_(x.mean((0, 2, 3)))
            self.w[f"{name}.var"].copy_(x.var((0, 2, 3), unbiased=False))
        scale, bias, mean, var = (self.w[f"{name}.{k}"] for k in BN_LEAVES)
        inv = scale / torch.sqrt(var + BN_EPS)
        return x * inv.view(1, -1, 1, 1) + (bias - mean * inv).view(1, -1, 1, 1)

    # ---- trunks
    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) mean-subtracted float32 -> (B, H/16, W/16, C).  The
        frozen layers run without autograd, as the recipe freezes them."""
        x = x.permute(0, 3, 1, 2)
        if self.backbone == "vgg16":
            for bi, (block, n, _) in enumerate(VGG_BLOCKS):
                if bi:
                    x = F.max_pool2d(x, 2, 2)
                for i in range(1, n + 1):
                    frozen = f"{block}_{i}" in VGG_FROZEN
                    with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
                        x = self.conv(x, f"extractor.{block}_{i}", relu=True)
        else:
            with torch.no_grad():
                x = torch.relu(self.frozen_bn(self.conv(x, "extractor.conv1", stride=2),
                                              "extractor.bn1"))
                x = F.max_pool2d(x, 3, 2, padding=1)
                x = self.stage(x, "extractor.res2", 3, 1)
            for stage, blocks, _, stride in RES_STAGES[1:]:
                x = self.stage(x, f"extractor.{stage}", blocks, stride)
        return x.permute(0, 2, 3, 1)

    def bottleneck(self, x: torch.Tensor, name: str, stride: int, project: bool
                   ) -> torch.Tensor:
        residual = x
        if project:
            residual = self.frozen_bn(self.conv(x, f"{name}.proj", stride), f"{name}.proj_bn")
        y = torch.relu(self.frozen_bn(self.conv(x, f"{name}.conv1", stride), f"{name}.bn1"))
        y = torch.relu(self.frozen_bn(self.conv(y, f"{name}.conv2"), f"{name}.bn2"))
        y = self.frozen_bn(self.conv(y, f"{name}.conv3"), f"{name}.bn3")
        return torch.relu(y + residual)

    def stage(self, x: torch.Tensor, name: str, blocks: int, stride: int) -> torch.Tensor:
        x = self.bottleneck(x, f"{name}.block1", stride, True)
        for i in range(2, blocks + 1):
            x = self.bottleneck(x, f"{name}.block{i}", 1, False)
        return x

    # ---- RPN and heads
    def rpn(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """feat (B, fH, fW, C) -> (fg_probs (B, fH, fW, A), logits
        (B, fH, fW, 2, A): channels bg/fg major, anchor minor, deltas
        (B, fH, fW, A, 4): anchor major, coordinate minor)."""
        h = self.conv(feat.permute(0, 3, 1, 2), "rpn.rpn_conv", relu=True)
        scores = self.conv(h, "rpn.rpn_cls_score").permute(0, 2, 3, 1)
        deltas = self.conv(h, "rpn.rpn_bbox_pred").permute(0, 2, 3, 1)
        b, fh, fw, a2 = scores.shape
        logits = scores.reshape(b, fh, fw, 2, a2 // 2)
        return (torch.softmax(logits, dim=3)[..., 1, :], logits,
                deltas.reshape(b, fh, fw, a2 // 2, 4))

    def head(self, crops: torch.Tensor, masks: Tuple[torch.Tensor, ...] = (),
             keep: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """crops (N, P, P, C) -> (cls_score (N, K), bbox_pred (N, 4K)).
        ``masks``: the VGG head's two dropout masks (N, hidden) bool, kept
        values divided by ``keep``."""
        if self.backbone == "vgg16":
            y = crops.reshape(crops.shape[0], -1)
            for i, layer in enumerate(("head.fc6", "head.fc7")):
                y = torch.relu(self.dense(y, layer))
                if masks:
                    y = torch.where(masks[i], y / keep, 0.0)
        else:
            y = self.stage(crops.permute(0, 3, 1, 2), "head.res5", RES5[1], RES5[3])
            y = y.mean((2, 3))
        return self.dense(y, "head.cls_score"), self.dense(y, "head.bbox_pred")

    def head_chunked(self, crops: torch.Tensor, chunk: int = 1000
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        outs = [self.head(crops[i:i + chunk]) for i in range(0, crops.shape[0], chunk)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def crop_size(cfg) -> int:
    """The RoI crop's side: the pool size, twice it for ResNet-101's res5,
    which halves it."""
    return cfg.roi.output_size * (2 if cfg.backbone == "resnet101" else 1)


def prepare(images: torch.Tensor, im_info: torch.Tensor, means: Tuple[float, ...]
            ) -> torch.Tensor:
    """uint8 (B, H, W, 3) canvas -> float32 minus the BGR means, zero outside
    each image's (scaled_h, scaled_w) extent."""
    x = images.float() - torch.tensor(means, dtype=torch.float32, device=images.device)
    _, h, w, _ = images.shape
    yy = torch.arange(h, device=images.device)[None, :, None, None]
    xx = torch.arange(w, device=images.device)[None, None, :, None]
    inside = (yy < im_info[:, 0, None, None, None]) & (xx < im_info[:, 1, None, None, None])
    return torch.where(inside, x, 0.0)


# ---------------------------------------------------------------- RoI pooling


def _quotient(a: torch.Tensor, d: int) -> torch.Tensor:
    """a / d rounded once, as IEEE division rounds it: on the card torch
    divides by a Python number as a product with its reciprocal, which
    moves some quotients by an ulp and with them the bins' edges."""
    return a / torch.full_like(a, float(d))


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def roi_max_pool(feat: torch.Tensor, rois: torch.Tensor, out: int, scale: float,
                 chunk: int = 128) -> torch.Tensor:
    """Caffe's roi_pooling_2d: feat (B, H, W, C), rois (B, R, 4) image
    coordinates -> (B * R, P, P, C).  Bin p of a RoI of size n cells spans
    [floor(p n / P), ceil((p + 1) n / P)) from the RoI's rounded start
    (n / P the float32 quotient), clipped to the map; an empty bin is 0."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    rois = rois.reshape(b * r, 4).float()
    img = torch.arange(b, device=feat.device).repeat_interleave(r)
    start = _round_half_away(rois * scale).to(torch.int64)            # x1 y1 x2 y2
    size_w = torch.clamp(start[:, 2] - start[:, 0] + 1, min=1)
    size_h = torch.clamp(start[:, 3] - start[:, 1] + 1, min=1)
    p = torch.arange(out, dtype=torch.float32, device=feat.device)
    outs = []
    for lo in range(0, b * r, chunk):
        sl = slice(lo, lo + chunk)
        n = img[sl].shape[0]

        def edges(size, s0, extent):
            binsz = _quotient(size[sl].float(), out)
            a = torch.floor(p * binsz[:, None]).long() + s0[sl, None]
            z = torch.ceil((p + 1.0) * binsz[:, None]).long() + s0[sl, None]
            return a.clamp(0, extent), z.clamp(0, extent)

        hs, he = edges(size_h, start[:, 1], h)
        ws, we = edges(size_w, start[:, 0], w)
        mh, mw = int((he - hs).max().clamp(min=1)), int((we - ws).max().clamp(min=1))
        dy = torch.arange(mh, device=feat.device)
        dx = torch.arange(mw, device=feat.device)
        yy = hs[:, :, None] + dy                                      # (n, P, mh)
        xx = ws[:, :, None] + dx
        ok_y, ok_x = yy < he[:, :, None], xx < we[:, :, None]
        # (n, P, P, mh, mw) cells of every bin
        lin = (img[sl, None, None, None, None] * (h * w)
               + yy.clamp(max=h - 1)[:, :, None, :, None] * w
               + xx.clamp(max=w - 1)[:, None, :, None, :])
        ok = ok_y[:, :, None, :, None] & ok_x[:, None, :, None, :]
        vals = feat.reshape(b * h * w, c)[lin.reshape(-1)].reshape(n, out, out, mh * mw, c)
        vals = torch.where(ok.reshape(n, out, out, mh * mw, 1), vals, float("-inf"))
        m = vals.amax(3)
        outs.append(torch.where(ok.reshape(n, out, out, -1).any(-1)[..., None], m, 0.0))
    return torch.cat(outs)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out: int, scale: float,
              sampling: int = 2, chunk: int = 250) -> torch.Tensor:
    """RoIAlign as the JAX package defines it: feat (B, H, W, C), rois
    (B, R, 4) -> (B * R, P, P, C) float32.  The RoI is x1 * scale .. x2 *
    scale (no +1, no half-pixel shift), its side at least 1; each bin
    averages s x s samples at (j + 0.5) / s of a bin, each clipped to
    [0, W - 1] before its floor, interpolated bilinearly from its four
    corner cells (the upper one clamped to the map)."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    rois = rois.reshape(b * r, 4).float() * scale
    img = torch.arange(b, device=feat.device).repeat_interleave(r)
    flat = feat.reshape(b * h * w, c).float()
    grid = (torch.arange(out * sampling, dtype=torch.float32, device=feat.device) + 0.5) / sampling
    outs = []
    for lo in range(0, b * r, chunk):
        ro = rois[lo:lo + chunk]
        n = ro.shape[0]

        def axis(x1, x2, size):
            binsz = _quotient(torch.clamp(x2 - x1, min=1.0), out)
            coord = torch.clamp(x1[:, None] + grid * binsz[:, None], 0.0, size - 1.0)
            low = torch.floor(coord)
            return low.long(), torch.clamp(low.long() + 1, max=size - 1), coord - low

        y0, y1, fy = axis(ro[:, 1], ro[:, 3], h)
        x0, x1, fx = axis(ro[:, 0], ro[:, 2], w)
        base = img[lo:lo + n, None, None] * (h * w)

        def corner(yi, xi):
            return flat[(base + yi[:, :, None] * w + xi[:, None, :]).reshape(-1)].reshape(
                n, out * sampling, out * sampling, c)

        wy, wx = fy[:, :, None, None], fx[:, None, :, None]
        v = (corner(y0, x0) * (1 - wy) * (1 - wx) + corner(y0, x1) * (1 - wy) * wx
             + corner(y1, x0) * wy * (1 - wx) + corner(y1, x1) * wy * wx)
        outs.append(v.reshape(n, out, sampling, out, sampling, c).mean((2, 4)))
    return torch.cat(outs)


def pool(net: Net, feat: torch.Tensor, rois: torch.Tensor, mode: str, scale: float
         ) -> torch.Tensor:
    if mode == "align":
        return roi_align(feat, rois, net.pool_size, scale)
    return roi_max_pool(feat, rois, net.pool_size, scale)


# ---------------------------------------------------------------- the layers


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every weight of the configuration ``cfg`` (its backbone, classes, RPN
    width, anchors per position, fc6/fc7 width and pool size): (name,
    shape, kind) with kind
    "conv", "dense", "bias", "rpn", "cls", "bbox", "conv3" (a bottleneck's
    last convolution) or one of the FrozenBN leaves "bn_scale", "bn_bias",
    "bn_mean", "bn_var"."""
    backbone, rpn_channels, pool_size = cfg.backbone, cfg.rpn_channels, cfg.roi.output_size
    feat_ch = FEAT_CHANNELS[backbone]
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def conv(name, cout, cin, k, bias=True, kind="conv"):
        spec.append((f"{name}.weight", (cout, cin, k, k), kind))
        if bias:
            spec.append((f"{name}.bias", (cout,), "bias"))

    def bn(name, ch):
        spec.extend((f"{name}.{leaf}", (ch,), f"bn_{leaf}") for leaf in BN_LEAVES)

    def stage(name, cin, blocks, ch, stride):
        for i in range(1, blocks + 1):
            blk = f"{name}.block{i}"
            if i == 1:
                conv(f"{blk}.proj", 4 * ch, cin, 1, bias=False)
                bn(f"{blk}.proj_bn", 4 * ch)
            conv(f"{blk}.conv1", ch, cin if i == 1 else 4 * ch, 1, bias=False)
            bn(f"{blk}.bn1", ch)
            conv(f"{blk}.conv2", ch, ch, 3, bias=False)
            bn(f"{blk}.bn2", ch)
            conv(f"{blk}.conv3", 4 * ch, ch, 1, bias=False, kind="conv3")
            bn(f"{blk}.bn3", 4 * ch)

    if backbone == "vgg16":
        cin = 3
        for block, n, ch in VGG_BLOCKS:
            for i in range(1, n + 1):
                conv(f"extractor.{block}_{i}", ch, cin, 3)
                cin = ch
    else:
        conv("extractor.conv1", 64, 3, 7, bias=False)
        bn("extractor.bn1", 64)
        cin = 64
        for name, blocks, ch, stride in RES_STAGES:
            stage(f"extractor.{name}", cin, blocks, ch, stride)
            cin = 4 * ch
    a = cfg.anchors.num_anchors
    conv("rpn.rpn_conv", rpn_channels, feat_ch, 3, kind="rpn")
    conv("rpn.rpn_cls_score", 2 * a, rpn_channels, 1, kind="rpn")
    conv("rpn.rpn_bbox_pred", 4 * a, rpn_channels, 1, kind="rpn")

    def dense(name, fout, fin, kind="dense"):
        spec.append((f"{name}.weight", (fout, fin), kind))
        spec.append((f"{name}.bias", (fout,), "bias"))

    if backbone == "vgg16":
        dense("head.fc6", cfg.head_hidden, pool_size * pool_size * feat_ch)
        dense("head.fc7", cfg.head_hidden, cfg.head_hidden)
        hid = cfg.head_hidden
    else:
        stage("head.res5", feat_ch, RES5[1], RES5[2], RES5[3])
        hid = 4 * RES5[2]
    dense("head.cls_score", cfg.num_classes, hid, kind="cls")
    dense("head.bbox_pred", 4 * cfg.num_classes, hid, kind="bbox")
    return spec


def runs_without_grad(name: str, backbone: str) -> bool:
    """The weights of the layers that run without autograd, so that no
    gradient reaches them: VGG-16 conv1_1-conv2_2, ResNet-101 conv1, bn1
    and res2."""
    parts = name.split(".")
    frozen = VGG_FROZEN if backbone == "vgg16" else R101_FROZEN
    return parts[0] == "extractor" and parts[1].startswith(frozen)


def is_frozen(name: str, backbone: str) -> bool:
    """The recipe's frozen weights, which the update never moves: those of
    :func:`runs_without_grad` and, for ResNet-101, every FrozenBN leaf."""
    return runs_without_grad(name, backbone) or (
        backbone != "vgg16" and any("bn" in p for p in name.split(".")))

"""Limits, decision margins and rounding-fault controls for comparing two
bfloat16 runs of the port: the port against the JAX package on the CPU
(tests/test_torch_bf16.py) and the card against the CPU (chip_smoke.py,
which loads this file by path).  numpy and the port only.

Two kinds of limit, each stated with the reading that must fail it:

* a **stage** from equal inputs (one layer, or one ResNet bottleneck, fed
  the reference's own input to it): both sides round at the same points
  from float32 sums that differ only in their order, so their bf16
  results differ only where a sum lies within that float32 disagreement of
  a rounding boundary.  The rms difference is then a small fraction of
  ``rho`` -- the rms difference one independent bf16 rounding on each side
  would make, ``sqrt(mean(ulp_i^2) / 6)`` over the reference's elements
  -- and :func:`stage` holds it to ``STAGE_RMS`` rho.  A side that rounds
  once more or once less anywhere in the stage (:func:`fused_rounding`),
  or sums its products in bf16 (:class:`Bf16Accumulation`), differs by
  about one such rounding and fails it (tests/test_torch_bf16.py asserts
  that on every stage).  The largest difference is also held to the first
  order bound ``min(r, lambda_n sqrt(r / 6))`` ulps of the scale for the
  stage's ``r`` rounding points (:func:`bf16_limit`; ``r`` is at most 10
  here);
* a **chain** of many stages (a trunk from the canvas, detect end to end,
  a training step's gradients): a difference carried through a stage
  moves other roundings, so deep chains decorrelate and the difference
  grows towards the graph's own rounding noise -- but no further: each
  side lies within that noise of the exact graph.  The float32 run of the
  same graph on the same inputs, ``x``, measures the reference's noise in
  the same run; the other side's, from the same rounding points, is
  distributed alike.  So :func:`chain` holds the largest difference to
  twice the reference's largest distance from ``x`` and the rms difference
  to sqrt(2) times its rms distance (two independent noises of that size),
  plus the two sides' last roundings.  A training step's gradients are
  held together (:func:`gradient_chains`).  Nothing here grows with the
  depth.  Summing every product in bf16
  (``Bf16Accumulation(2)`` and finer) fails the rms limit; one rounding
  more or less per layer does not at ResNet-101's depth, which is why
  every layer is also held as a stage.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

T = torch.from_numpy

# a stage's rms difference, in units of rho: the largest sound reading
# (the port against JAX on the CPU, every VGG-16 layer and ResNet-101
# bottleneck) is 0.135, the smallest of a one-rounding fault 0.47
STAGE_RMS = 0.25


def bf16_ulp(x):
    """Spacing of bfloat16 values at |x| (8 significant bits), as chip_smoke."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def lam(n: int) -> float:
    return math.sqrt(2.0 * math.log(2.0 * n / 1e-6))


def bf16_limit(want, r: int) -> float:
    """The first-order limit on the largest difference for ``r`` bf16
    rounding points from equal inputs, in the units of ``want``:
    ``min(r, lambda_n sqrt(r / 6))`` bf16 ulps of its largest magnitude
    (each point at most one ulp, carried by layers that keep an error's
    size relative to the activations; or independent zero-mean roundings of
    variance ulp^2 / 6, whose largest of n stays within lambda_n standard
    deviations)."""
    want = np.asarray(want, np.float32)
    return min(r, lam(want.size) * math.sqrt(r / 6.0)) * float(bf16_ulp(np.abs(want).max()))


def ulps(got, want) -> float:
    """The largest difference in bf16 ulps of want's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / bf16_ulp(np.abs(want).max()))


def rho(want) -> float:
    """The rms difference one independent bf16 rounding on each side makes
    at ``want``'s elements: sqrt(mean(ulp_i^2) / 6)."""
    return float(np.sqrt(np.mean(bf16_ulp(want) ** 2) / 6.0))


def _rms(d) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(d, np.float64)))))


def _pair(got, want, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    return got.astype(np.float64), want.astype(np.float64)


def stage(what, got, want, r, check=True):
    """A stage from equal inputs: the largest difference within
    :func:`bf16_limit` at ``r`` points and the rms difference within
    STAGE_RMS rho.  Returns (largest difference in ulps of the scale, rms
    difference in rho); ``check=False`` only measures."""
    got, want = _pair(got, want, what)
    d = got - want
    big, rms = float(np.abs(d).max()), _rms(d) / rho(want)
    if check:
        limit = bf16_limit(want, r)
        assert big <= limit, (f"{what}: {ulps(got, want):.2f} ulps of the scale "
                              f"{np.abs(want).max():.4g}, limit {limit:.4g} (r={r})")
        assert rms <= STAGE_RMS, f"{what}: rms difference {rms:.3f} rho, limit {STAGE_RMS}"
    return round(ulps(got, want), 3), round(rms, 4)


def chain_limits(want, x):
    """(largest, rms) limits of a chain's difference from ``want``: twice
    the largest and sqrt(2) times the rms distance of the float32 run ``x``
    from ``want``, and the two sides' last roundings, which that distance
    holds once and may hold at any size: one ulp of the scale on the
    largest, rho (added in quadrature) on the rms."""
    x, want = _pair(x, want, "float32 run")
    d = x - want
    return (2.0 * float(np.abs(d).max()) + float(bf16_ulp(np.abs(want).max())),
            math.sqrt(2.0 * _rms(d) ** 2 + rho(want) ** 2))


def chain(what, got, want, x, check=True):
    """A chain: the difference from ``want`` within :func:`chain_limits`
    of the float32 run ``x``.  Returns (largest, rms) as fractions of
    their limits; ``check=False`` only measures."""
    got, want = _pair(got, want, what)
    big_lim, rms_lim = chain_limits(want, x)
    d = got - want
    frac = (float(np.abs(d).max()) / big_lim if big_lim else float(np.abs(d).max() > 0) * np.inf,
            _rms(d) / rms_lim if rms_lim else float(np.abs(d).max() > 0) * np.inf)
    if check:
        assert frac[0] <= 1.0 and frac[1] <= 1.0, (
            f"{what}: largest difference {frac[0]:.3f} and rms {frac[1]:.3f} of their limits "
            f"(twice the float32 run's largest distance {big_lim / 2:.4g}, sqrt(2) times its "
            f"rms {rms_lim / math.sqrt(2.0):.4g})")
    return round(frac[0], 3), round(frac[1], 3)


# a trained tensor's gradient, as a fraction of its chain's limits: a small
# tensor's noise reading is a poor estimate of its noise (an H100 against
# the CPU: the RPN's biases, 36 and 64 elements, read 1.38 and 1.42 of
# their rms limits, ResNet-101's rpn_conv weight 1.06, the others about
# 0.5), so each is held to GRAD_CAP times its limits and the tensors
# together to the limit itself
GRAD_CAP = 2.0


def gradient_chains(what, got, ref, x, check=True):
    """A training step's gradients (dicts of arrays by name; the tensors
    of ``got``) as chains: each tensor's (largest, rms) fractions of its
    limits within GRAD_CAP,
    and the rms over the tensors of their rms fractions within 1 (a
    rounding fault moves most tensors' noise; one tensor's reading moves
    by chance).  Returns the fractions by name and that pooled rms."""
    read = {k: chain(f"{what} gradient of {k}", got[k], ref[k], x[k], check=False) for k in got}
    pooled = math.sqrt(float(np.mean([r[1] ** 2 for r in read.values()])))
    if check:
        over = {k: r for k, r in read.items() if max(r) > GRAD_CAP}
        assert not over, f"{what}: gradients over {GRAD_CAP} times their limits: {over}"
        assert pooled <= 1.0, f"{what}: the gradients' pooled rms fraction {pooled:.3f}"
    return read, round(pooled, 3)


# ------------------------------------------------------------ rounding-fault controls


@contextlib.contextmanager
def fused_rounding():
    """The port with one bf16 rounding fewer at every layer: a convolution
    or matmul and its bias rounded once (a bias folded into ``F.conv2d``),
    a FrozenBN's multiply and add rounded once (the BN folded), in every
    epilogue's plain version (``frozen_bn.affine``, the CPU's path)."""
    from trcnn_torch.models import resnet, roi_head, rpn, vgg16
    from trcnn_torch.ops import frozen_bn as fbn

    def conv_nchw(x, conv, relu=True):
        y = F.conv2d(x.float(), conv.weight.float(), conv.bias.float(),
                     padding=conv.padding).to(x.dtype)
        return torch.relu(y) if relu else y

    def dense(x, layer):
        return F.linear(x.float(), layer.weight.float(), layer.bias.float()).to(x.dtype)

    def affine(x, scale, bias, mean, var, eps):
        inv = scale / torch.sqrt(var + eps)
        shift = bias - mean * inv
        return (x.float() * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)

    saved = (vgg16.conv_nchw, rpn.conv_nchw, roi_head.dense, resnet.dense, fbn.affine)
    vgg16.conv_nchw = rpn.conv_nchw = conv_nchw
    roi_head.dense = resnet.dense = dense
    fbn.affine = affine
    try:
        yield
    finally:
        (vgg16.conv_nchw, rpn.conv_nchw, roi_head.dense, resnet.dense, fbn.affine) = saved


class Bf16Accumulation(torch.overrides.TorchFunctionMode):
    """The port summing in bf16: every bf16 convolution and matmul split
    into groups of ``ch`` input channels, each group's float32 sum rounded
    to bf16 and the groups added in bf16 (``ch=1``: every product's
    channel sum added in bf16, as JAX's CPU backward sums)."""

    def __init__(self, ch: int):
        super().__init__()
        self.ch = ch

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (F.conv2d, F.linear) and args[0].dtype == torch.bfloat16:
            x, w, rest = args[0], args[1], args[2:]
            dim = 1 if func is F.conv2d else -1
            n = x.shape[dim]
            if n > self.ch:
                out = None
                for s in range(0, n, self.ch):
                    part = func(x.narrow(dim, s, min(self.ch, n - s)),
                                w.narrow(1, s, min(self.ch, n - s)), *rest, **kwargs)
                    out = part if out is None else out + part
                return out
        return func(*args, **kwargs)


def decode_limit(anchor_cfg, deltas, dlim):
    """How far a proposal's corner can move when its deltas move by at most
    ``dlim``: dx and dy move the centre by the anchor's side times dlim,
    dw and dh the half side by half the decoded side times dlim (first
    order; clipping moves nothing further)."""
    side = anchor_cfg.base_size * max(anchor_cfg.scales) * math.sqrt(max(anchor_cfg.ratios))
    return side * (1.0 + 0.5 * math.exp(float(np.abs(deltas).max()) + dlim)) * dlim


def iou_np(a, b):
    """IoU of (4,) box a against (N, 4) boxes b, +1 pixel convention."""
    iw = np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]) + 1.0
    ih = np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]) + 1.0
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area = lambda x: (x[..., 2] - x[..., 0] + 1.0) * (x[..., 3] - x[..., 1] + 1.0)  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def proposal_flips(cfg, jrpn, prpn, jprops, pprops, info):
    """Where the port's proposals (from its own RPN tensors ``prpn``) keep a
    box that JAX's (from ``jrpn``) do not, or the other way round, or keep
    two boxes in the other order: the decision behind it, read from JAX's
    own values, and its margin to its threshold beside how far the port's
    inputs to that decision moved.

    Each side's candidates are decoded from all anchors with its own
    tensors; a kept box is matched to its anchor there, and to the other
    side's kept box within the largest corner difference.  The decisions
    are the pre-NMS top-k cut (margin: JAX's score against the k-th score;
    moved: the largest |fg_probs| difference), the minimum size (JAX's
    smaller side against min_size; moved: twice the largest corner
    difference), NMS (JAX's IoU with a box kept on either side against the
    threshold; moved: the largest change of that IoU between the two
    sides), the post-NMS cap when a side keeps its full count (JAX's score
    against its last kept box's; moved: twice the |fg_probs| move) and which of two boxes comes first (JAX's score difference;
    moved: twice the largest |fg_probs| difference).  Returns the flips
    [(image, anchor or slots, decision, margin, moved)], each for the
    decision with the least margin, and per image the (port slot, JAX
    slot) pairs of the boxes both keep; raises where a difference has no
    decision within its move."""
    from trcnn_torch.ops.anchors import shifted_anchors
    from trcnn_torch.ops.boxes import bbox_transform_inv, clip_boxes

    fg_j, fg_p = (np.asarray(r.fg_probs, np.float32) for r in (jrpn, prpn))
    b, fh, fw, a = fg_j.shape
    anchors = shifted_anchors(fh, fw, cfg.anchors)
    k = cfg.proposals.pre_nms_topk_test
    thresh = cfg.proposals.nms_thresh
    flips, matches = [], []
    for i in range(b):
        dec = []
        for r in (jrpn, prpn):
            d = T(np.asarray(r.deltas, np.float32)[i].reshape(-1, 4))
            dec.append(clip_boxes(bbox_transform_inv(anchors, d), float(info[i, 0]),
                                  float(info[i, 1])).numpy())
        box_move = float(np.abs(dec[0] - dec[1]).max())
        fg_move = float(np.abs(fg_j[i] - fg_p[i]).max())
        kept = [np.asarray(p.rois[i])[np.asarray(p.valid[i])] for p in (jprops, pprops)]
        score_j = fg_j[i].reshape(-1)
        cut = np.sort(score_j)[::-1][k - 1]
        # JAX's score of its last kept box (the post-NMS cap's cut when full)
        last = np.abs(dec[0] - kept[0][-1]).max(1) if len(kept[0]) else np.zeros(1)
        last_j = float(np.max(np.where(last <= last.min(), score_j, -1.0)))
        pairs = []          # (port slot, JAX slot, JAX score) of the boxes both keep
        for side, other in ((0, 1), (1, 0)):
            for slot, box in enumerate(kept[side]):
                # the best-scoring anchor of those decoding to this box (NMS
                # keeps the first of equal boxes)
                dist = np.abs(dec[side] - box).max(1)
                score = (fg_j, fg_p)[side][i].reshape(-1)
                idx = int(np.argmax(np.where(dist <= dist.min(), score, -1.0)))
                near = np.abs(kept[other] - box).max(1) if len(kept[other]) else np.inf
                if np.min(near) <= box_move:
                    if side == 1:
                        pairs.append((slot, int(np.argmin(near)), score_j[idx]))
                    continue
                jb = dec[0][idx]
                cands = [("top-k cut", abs(score_j[idx] - cut), fg_move),
                         ("min size", abs(min(jb[2] - jb[0], jb[3] - jb[1]) + 1.0
                                          - cfg.proposals.min_size * info[i, 2]), 2 * box_move)]
                if max(map(len, kept)) == cfg.proposals.post_nms_topk_test:
                    cands.append(("post-NMS cap", abs(score_j[idx] - last_j), 2 * fg_move))
                for kb in np.concatenate(kept):
                    if np.abs(kb - box).max() <= box_move:
                        continue
                    dist = np.abs(dec[0] - kb).max(1)
                    kidx = int(np.argmax(np.where(dist <= dist.min(), score_j, -1.0)))
                    iou_j = iou_np(jb, dec[0][kidx:kidx + 1])[0]
                    iou_p = iou_np(dec[1][idx], dec[1][kidx:kidx + 1])[0]
                    cands.append(("NMS IoU", abs(iou_j - thresh), abs(iou_j - iou_p)))
                    if max(iou_j, iou_p) > thresh:
                        cands.append(("NMS score order", abs(score_j[idx] - score_j[kidx]),
                                      2 * fg_move))
                name, margin, moved = min(cands, key=lambda c: c[1] - c[2])
                assert margin <= moved, (
                    f"image {i}: a kept box differs ({'port' if side else 'JAX'} only, "
                    f"anchor {idx}) with no decision within its move of its threshold: "
                    f"{cands}")
                flips.append((i, idx, name, float(margin), float(moved)))
        for a_p, a_j, s_a in pairs:
            for b_p, b_j, s_b in pairs:
                if a_p < b_p and a_j > b_j:
                    assert abs(s_a - s_b) <= 2 * fg_move, (i, a_p, b_p, s_a, s_b, fg_move)
                    flips.append((i, (a_p, b_p), "kept order", float(abs(s_a - s_b)),
                                  2 * fg_move))
        matches.append([(p_, j_) for p_, j_, _ in pairs])
    return flips, matches


def decode_limit_px(cfg, dets, d_box):
    """How far a detection's corner can move when bbox_pred moves by at most
    d_box: the RoI's side times the de-normalising std (0.1 centre, 0.2
    size) and the exp's factor on the size, the side bounded by the
    largest box here (in canvas pixels, so at least the original image's).
    A RoI corner's own move d carries into the box as at most
    d (1 + exp(0.2 |dh|) / 2), under 2.5 d for the deltas here."""
    stds = cfg.proposal_targets.bbox_normalize_stds
    b = dets[0][dets[3]]
    side = float(np.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]).max() + 1.0) if len(b) else 1.0
    return side * (max(stds[:2]) + 0.5 * max(stds[2:]) * math.exp(max(stds[2:]) * d_box)) * d_box + 1e-3


def iou_move(a, b, d):
    """How far IoU(a, b) can move when every corner moves by at most d."""
    iw = max(min(a[2], b[2]) - max(a[0], b[0]) + 1.0, 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]) + 1.0, 0.0)
    wa, ha, wb, hb = a[2] - a[0] + 1, a[3] - a[1] + 1, b[2] - b[0] + 1, b[3] - b[1] + 1
    inter = iw * ih
    union = wa * ha + wb * hb - inter
    d_i = 2 * d * (iw + ih) + 4 * d * d
    d_u = 2 * d * (wa + ha + wb + hb) + 8 * d * d + d_i
    return (d_i + inter / union * d_u) / max(union - d_u, 1e-9)


def detection_flips(cfg, got, want, prob_move, box_move, info):
    """The epilogue's counterpart of :func:`proposal_flips` on detections
    (boxes, scores, classes, valid), numpy, from the same proposals: a
    detection kept on one side only, or two in the other order, with the
    decision behind it read from JAX's values: the score threshold (margin:
    the score against it; moved: the largest |cls_prob| difference), the
    per-image cut (the score against either side's last kept score; moved:
    twice that), per-class NMS
    (JAX's IoU with a same-class detection against the threshold; moved:
    :func:`iou_move` for the largest corner difference), which of two
    same-class boxes over the threshold comes first and the order of the
    kept ones (the two scores' difference; moved: twice the |cls_prob|
    move); a
    detection suppressed on one side by a higher-scoring one that side
    alone keeps follows that one's decision (margin 0).  Returns the
    flips; raises where one has no decision within its move."""
    t = cfg.test
    flips = []
    for i in range(len(want[3])):
        # in canvas pixels, where the epilogue's NMS compares them
        side_dets = [[(d[0][i][k] * info[i, 2], d[1][i][k], d[2][i][k])
                      for k in np.flatnonzero(d[3][i])] for d in (want, got)]
        lasts = [min((s for _, s, _ in d), default=0.0) for d in side_dets]
        near = {(side, slot): [k for k, (b2, _, c2) in enumerate(side_dets[1 - side])
                               if c2 == cls and np.abs(b2 - box).max() <= box_move]
                for side in (0, 1) for slot, (box, _, cls) in enumerate(side_dets[side])}
        alone = [side_dets[side][slot] for (side, slot), n in near.items() if not n]
        pairs = []
        for side in (0, 1):
            for slot, (box, score, cls) in enumerate(side_dets[side]):
                if near[side, slot]:
                    if side == 1:
                        pairs.append((slot, near[side, slot][0], score))
                    continue
                cands = [("score threshold", abs(score - t.score_thresh_eval), prob_move),
                         ("per-image cut", min(abs(score - x) for x in lasts), 2 * prob_move)]
                for b2, s2, c2 in side_dets[0] + side_dets[1]:
                    if c2 == cls and np.abs(b2 - box).max() > box_move:
                        iou = iou_np(box, b2[None])[0]
                        cands.append(("NMS IoU", abs(iou - t.nms_thresh),
                                      iou_move(box, b2, box_move)))
                        if iou > t.nms_thresh:      # which of the two comes first
                            cands.append(("NMS score order", abs(score - s2), 2 * prob_move))
                        # a higher-scoring box kept on one side only suppresses it
                        if (s2 > score and iou > t.nms_thresh
                                and any(b2 is a[0] for a in alone)):
                            cands.append(("NMS behind a differing box", 0.0, 0.0))
                name, margin, moved = min(cands, key=lambda c: c[1] - c[2])
                assert margin <= moved, (
                    f"image {i}: a detection differs ({'port' if side else 'JAX'} only: class "
                    f"{cls}, score {score:.4f}, box {box}) with no decision within its move: "
                    f"{sorted(cands, key=lambda c: c[1] - c[2])[:3]}; same class: "
                    f"{[(b2, s2) for b2, s2, c2 in side_dets[1 - side] if c2 == cls]}")
                flips.append((i, slot, name, float(margin), float(moved)))
        for a_p, a_j, s_a in pairs:
            for b_p, b_j, s_b in pairs:
                if a_p < b_p and a_j > b_j:
                    assert abs(s_a - s_b) <= 2 * prob_move, (i, a_p, b_p, s_a, s_b, prob_move)
                    flips.append((i, (a_p, b_p), "detection order", float(abs(s_a - s_b)),
                                  2 * prob_move))
    return flips


class Props:
    def __init__(self, rois, valid):
        self.rois, self.valid = rois, valid


def within(what, got, want, limit):
    """|got - want| within ``limit``; returns the largest difference in
    ulps of want's scale."""
    got, want = _pair(got, want, what)
    err = float(np.abs(got - want).max())
    assert err <= limit, (f"{what}: {err:.4g} = {ulps(got, want):.2f} ulps of the scale "
                          f"{np.abs(want).max():.4g}, limit {limit:.4g}")
    return round(ulps(got, want), 3)


def compare_detect(what, cfg, ref, got, x, info, head_on, epilogue, min_dets=4):
    """Two bf16 runs of detect from the same canvases: ``got`` (rpn,
    rois, roi_valid, cls_prob, bbox_pred; numpy, the RPN tensors a
    NamedTuple) against ``ref`` (the same and cls_score and dets), each a
    :func:`chain` with the float32 run ``x`` (logits, deltas, fg_probs,
    and cls_score, cls_prob, bbox_pred on ref's proposals).  The RPN
    tensors within their chain limits; the proposals' validity equal and
    the kept boxes' corners within the decode's move for the deltas'
    largest limit, or each differing kept box within its decision's margin
    (:func:`proposal_flips`); cls_prob on the boxes both keep within its
    chain limits; the detections' validity and classes equal and scores
    within cls_prob's largest limit, or each difference within its
    decision's margin (:func:`detection_flips`).  Where a kept box differs,
    the head (``head_on(rois)`` -> cls_prob, bbox_pred of got's features)
    and the epilogue (``epilogue(rois, valid, cls_prob, bbox_pred)`` ->
    dets) run on ref's proposals.  Returns what it measured: each
    tensor's (largest, rms) difference as fractions of its limits."""
    rpn, ref_rpn = got["rpn"], ref["rpn"]
    ref_deltas = _f32(ref_rpn.deltas)
    read = {k: chain(f"{what} rpn {k}", getattr(rpn, k), getattr(ref_rpn, k), x[k])
            for k in ("logits", "deltas", "fg_probs")}
    dlim = chain_limits(ref_deltas, x["deltas"])[0]
    flips, matches = proposal_flips(cfg, ref_rpn, rpn, Props(ref["rois"], ref["roi_valid"]),
                                    Props(got["rois"], got["roi_valid"]), info)
    rlim = decode_limit(cfg.anchors, ref_deltas, dlim)
    plim = chain_limits(ref["cls_prob"], x["cls_prob"])[0]
    if not flips:
        np.testing.assert_array_equal(got["roi_valid"], ref["roi_valid"])
    pairs = [(got["rois"][i, p_], got["cls_prob"][i, p_], ref["rois"][i, j_],
              ref["cls_prob"][i, j_], x["cls_prob"][i, j_])
             for i, m in enumerate(matches) for p_, j_ in m]
    d_rois = float(np.abs(np.stack([g[0] - g[2] for g in pairs])).max())
    assert d_rois <= rlim, (what, d_rois, rlim)
    read["cls_prob"] = chain(f"{what} cls_prob", *(np.stack([g[k] for g in pairs])
                                                   for k in (1, 3, 4)))
    rois, valid, prob, bbox_pred = got["rois"], got["roi_valid"], got["cls_prob"], got["bbox_pred"]
    if flips:
        rois, valid = ref["rois"], ref["roi_valid"]
        prob, bbox_pred = head_on(rois)
        chain(f"{what} cls_prob on the reference's proposals", prob, ref["cls_prob"],
              x["cls_prob"])
    dets = epilogue(rois, valid, prob, bbox_pred)
    want = [np.asarray(a) for a in ref["dets"]]
    assert want[3].sum() >= min_dets, (what, int(want[3].sum()))
    d_box = float(np.abs(bbox_pred - ref["bbox_pred"]).max())
    # the detections' RoIs are got's own where no kept box differs
    box_move = decode_limit_px(cfg, want, d_box) + (0.0 if flips else 2.5 * d_rois)
    d_prob = float(np.abs(prob - ref["cls_prob"]).max())
    det_flips = detection_flips(cfg, dets, want, d_prob, box_move, info)
    if not det_flips:
        np.testing.assert_array_equal(dets[3], want[3])
        np.testing.assert_array_equal(dets[2], want[2])
        within(f"{what} scores", dets[1], want[1], plim)
    return dict(read=read, rois_px=d_rois, rois_limit_px=rlim, cls_prob=d_prob,
                cls_prob_limit=plim, flips=flips + det_flips)


def _row_move(want, x, axis):
    """A chain's limit on the mean over rows of a row's largest change:
    twice the float32 run's (the rows along ``axis``), plus the two last
    roundings (one ulp of each row's largest magnitude)."""
    rows = lambda a: np.moveaxis(a, axis, -1).reshape(-1, a.shape[axis])  # noqa: E731
    want = _f32(want).astype(np.float64)
    d = rows(np.abs(_f32(x) - want))
    return (2.0 * float(d.max(-1).mean())
            + float(np.mean(bf16_ulp(rows(np.abs(want)).max(-1)))))


def loss_limits(ref, x):
    """The four losses' limits between two bf16 runs of one training step,
    from the tensors they are computed from (``ref`` and the float32 run
    ``x``: rpn logits (B, H, W, 2, A) and deltas, the head's cls_score and
    bbox_pred): a loss is a mean over rows (anchors, RoIs) of a function
    that moves by at most twice its row's largest change (cross-entropy of
    the row's logits) or four times it (smooth L1 of its four deltas), so
    by at most that times the mean over rows of the row's largest change,
    held as a chain (:func:`_row_move`; the normalisers count at most the
    rows).  ``loss`` their sum."""
    lim = {"rpn_cls_loss": 2 * _row_move(ref["logits"], x["logits"], 3),
           "rpn_bbox_loss": 4 * _row_move(ref["deltas"], x["deltas"], -1),
           "cls_loss": 2 * _row_move(ref["cls_score"], x["cls_score"], -1),
           "bbox_loss": 4 * _row_move(ref["bbox_pred"], x["bbox_pred"], -1)}
    lim["loss"] = sum(lim.values())
    return lim


def _f32(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu()
    return np.asarray(t, np.float32)

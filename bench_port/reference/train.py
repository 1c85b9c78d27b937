"""The training step of Faster R-CNN in plain float32 PyTorch: anchor
targets, proposal targets, the four losses of approximate joint training,
their gradients by autograd, and the Caffe-order momentum update.

A translation of ``tests/cross_impl_train_reference.py`` that imports
neither the JAX package nor the port.  The target layers are numpy on the
host, per image (inside-anchor mask, per-gt argmax with every tie, the IoU
bands, the fg/bg quotas by ranking uniforms, the gt appended to the
proposals, the replacement fill of short samples).  As in that file the
sampling randomness is shared, not re-implemented: the uniforms and the
dropout masks are drawn by the rule a run of the port draws them by, from
a generator seeded with ``(seed << 32) + step`` on the card
(:func:`draws`), so that the sampled sets can be compared decision for
decision while the logic stays independent.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench_port.reference import boxes as rb
from bench_port.reference.nets import Net, is_frozen, pool, prepare, runs_without_grad

F32 = np.float32
LOSSES = ("rpn_cls_loss", "rpn_bbox_loss", "cls_loss", "bbox_loss")


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, K) float32 IoU under the +1 convention, IEEE quotient."""
    area_a = ((a[:, 2] - a[:, 0] + F32(1)) * (a[:, 3] - a[:, 1] + F32(1)))[:, None]
    area_b = ((b[:, 2] - b[:, 0] + F32(1)) * (b[:, 3] - b[:, 1] + F32(1)))[None, :]
    iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]) + F32(1), F32(0))
    ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]) + F32(1), F32(0))
    inter = iw * ih
    union = area_a + area_b - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, F32(0)).astype(F32)


def encode(ex: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(dx, dy, dw, dh) of gt relative to ex (+1 widths)."""
    ew, eh = ex[:, 2] - ex[:, 0] + F32(1), ex[:, 3] - ex[:, 1] + F32(1)
    gw, gh = gt[:, 2] - gt[:, 0] + F32(1), gt[:, 3] - gt[:, 1] + F32(1)
    ecx, ecy = ex[:, 0] + F32(0.5) * (ew - F32(1)), ex[:, 1] + F32(0.5) * (eh - F32(1))
    gcx, gcy = gt[:, 0] + F32(0.5) * (gw - F32(1)), gt[:, 1] + F32(0.5) * (gh - F32(1))
    return np.stack([(gcx - ecx) / ew, (gcy - ecy) / eh, np.log(gw / ew), np.log(gh / eh)],
                    1).astype(F32)


def smallest_u(mask: np.ndarray, u: np.ndarray, cap: int) -> np.ndarray:
    """The members of ``mask`` with the ``cap`` smallest draws, in draw order."""
    idx = np.flatnonzero(mask)
    return idx[np.argsort(u[idx], kind="stable")][:max(int(cap), 0)]


def anchor_targets(anchors, gt, gt_valid, im_h, im_w, u_fg, u_bg, c):
    """labels (N,) {1, 0, -1}, targets (N, 4), sampled count."""
    n = anchors.shape[0]
    ab = F32(c.allowed_border)
    inside = ((anchors[:, 0] >= -ab) & (anchors[:, 1] >= -ab)
              & (anchors[:, 2] < F32(im_w) + ab) & (anchors[:, 3] < F32(im_h) + ab))
    m = iou(anchors, gt)
    m[:, ~gt_valid] = 0
    m[~inside] = 0
    max_iou, arg = m.max(1), m.argmax(1)
    gt_max = m.max(0)
    is_arg = ((m == gt_max[None]) & (gt_max[None] > 0) & gt_valid[None]).any(1)
    pos = inside & (is_arg | (max_iou >= F32(c.positive_iou))) & bool(gt_valid.any())
    neg = inside & (max_iou < F32(c.negative_iou)) & ~pos
    fg = smallest_u(pos, u_fg, int(c.fg_fraction * c.batch_size))
    bg = smallest_u(neg, u_bg, c.batch_size - len(fg))
    labels = np.full(n, -1, np.int64)
    labels[bg], labels[fg] = 0, 1
    targets = np.zeros((n, 4), F32)
    if len(fg):
        targets[fg] = encode(anchors[fg], gt[arg[fg]])
    return labels, targets, len(fg) + len(bg)


def proposal_targets(rois, roi_valid, gt, gt_labels, gt_valid, u_fg, u_bg, c):
    """Sampled (rois (S, 4), labels (S,), normalised targets (S, 4), is_fg,
    valid): gt joins the candidates, fg up to round(fg_fraction S), bg
    fills to S, a short sample cycles its bg (its fg when there is none),
    no candidate leaves every slot invalid."""
    s = c.rois_per_image
    cand = np.concatenate([rois, gt]).astype(F32)
    cand_valid = np.concatenate([roi_valid, gt_valid])
    m = iou(cand, gt)
    m[:, ~gt_valid] = 0
    max_iou, arg = m.max(1), m.argmax(1)
    fg = smallest_u(cand_valid & (max_iou >= F32(c.fg_iou)), u_fg,
                    int(round(c.fg_fraction * s)))
    bg = smallest_u(cand_valid & (max_iou < F32(c.bg_iou_hi)) & (max_iou >= F32(c.bg_iou_lo)),
                    u_bg, s - len(fg))
    sel = np.concatenate([fg, bg]).astype(np.int64)
    take = np.zeros(s, np.int64)
    valid = np.zeros(s, bool)
    if len(sel):
        for slot in range(s):
            over = slot - len(sel)
            if over < 0:
                take[slot] = sel[slot]
            elif len(bg):
                take[slot] = bg[over % len(bg)]
            else:
                take[slot] = fg[over % len(fg)]
        valid[:] = True
    is_fg = np.isin(take, fg) & valid
    labels = np.where(is_fg, gt_labels[arg[take]], 0).astype(np.int64)
    t = (encode(cand[take], gt[arg[take]]) - np.asarray(c.bbox_normalize_means, F32)) \
        / np.asarray(c.bbox_normalize_stds, F32)
    return (np.where(valid[:, None], cand[take], 0).astype(F32), labels,
            np.where(is_fg[:, None], t, 0).astype(F32), is_fg, valid)


def draws(seed: int, step: int, b: int, n_anchors: int, n_cand: int, mask_shape,
          mask_dtype, keep: float, device) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """The step's sampling uniforms (at_fg, at_bg over the anchors, pt_fg,
    pt_bg over the candidates) and, for a head with dropout
    (``mask_shape`` not None), its two masks, in the order a step draws
    them from its generator."""
    gen = torch.Generator(device=device).manual_seed((seed << 32) + step)
    uni = {k: torch.rand((b, n_anchors if k.startswith("at") else n_cand), generator=gen,
                         device=device) for k in ("at_fg", "at_bg", "pt_fg", "pt_bg")}
    masks = ()
    if mask_shape is not None and keep < 1.0:
        masks = tuple(torch.empty(mask_shape, dtype=mask_dtype, device=device)
                      .bernoulli_(keep, generator=gen).bool() for _ in range(2))
    return uni, masks


def smooth_l1(x: torch.Tensor, sigma: float) -> torch.Tensor:
    s2 = sigma * sigma
    ax = x.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels[..., None])[..., 0]


def losses(net: Net, cfg, batch: Dict[str, torch.Tensor], props: Tuple[np.ndarray, np.ndarray],
           uni: Dict[str, torch.Tensor], masks: Tuple) -> Dict[str, torch.Tensor]:
    """The four losses of a batch with autograd through ``net``'s weights.
    ``props``: the proposals (rois (B, P, 4), valid (B, P)) the sampling
    runs on."""
    images, im_info = batch["images"], batch["im_info"]
    b = images.shape[0]
    feat = net.trunk(prepare(images, im_info, cfg.image.pixel_means_bgr))
    _, logits, deltas = net.rpn(feat)
    _, fh, fw, a = deltas.shape[:4]
    n = fh * fw * a
    ac = cfg.anchors
    anchors = rb.all_anchors(fh, fw, ac.feat_stride,
                             rb.base_anchors(ac.base_size, ac.ratios, ac.scales), "cpu").numpy()
    logits = logits.reshape(b, fh * fw, 2, a).transpose(2, 3).reshape(b, n, 2)
    deltas = deltas.reshape(b, n, 4)
    gt = batch["gt_boxes"].float().cpu().numpy()
    gl = batch["gt_labels"].cpu().numpy()
    gv = batch["gt_valid"].cpu().numpy()
    info = im_info.float().cpu().numpy()
    u = {k: v.cpu().numpy() for k, v in uni.items()}
    dev = images.device
    rpn_cls, rpn_box, samples = 0.0, 0.0, []
    for i in range(b):
        labels, targets, num = anchor_targets(anchors, gt[i], gv[i], info[i, 0], info[i, 1],
                                              u["at_fg"][i], u["at_bg"][i], cfg.anchor_targets)
        labels, targets = torch.from_numpy(labels).to(dev), torch.from_numpy(targets).to(dev)
        denom = float(max(num, 1))
        ce = softmax_ce(logits[i], labels.clamp(min=0))
        rpn_cls = rpn_cls + torch.where(labels >= 0, ce, 0.0).sum() / denom
        l1 = smooth_l1(deltas[i] - targets, cfg.loss.rpn_smooth_l1_sigma).sum(-1)
        rpn_box = rpn_box + torch.where(labels == 1, l1, 0.0).sum() / denom
        samples.append(proposal_targets(props[0][i], props[1][i], gt[i], gl[i], gv[i],
                                        u["pt_fg"][i], u["pt_bg"][i], cfg.proposal_targets))
    s_rois, s_labels, s_targets, s_fg, s_valid = (
        torch.from_numpy(np.stack([smp[j] for smp in samples])).to(dev) for j in range(5))
    crops = pool(net, feat, s_rois, cfg.roi.mode, cfg.roi.spatial_scale)
    cls_score, bbox_pred = net.head(crops, masks, 1.0 - cfg.head_dropout)
    s = s_labels.shape[1]
    lab = s_labels.reshape(-1)
    ce = softmax_ce(cls_score, lab)
    valid = s_valid.reshape(-1)
    cls_loss = torch.where(valid, ce, 0.0).sum() / valid.sum().clamp(min=1)
    pred = bbox_pred.reshape(b * s, -1, 4)[torch.arange(b * s, device=dev), lab]
    hl1 = smooth_l1(pred - s_targets.reshape(-1, 4), cfg.loss.head_smooth_l1_sigma).sum(-1)
    bbox_loss = torch.where(s_fg.reshape(-1), hl1, 0.0).sum() / float(b * s)
    out = {"rpn_cls_loss": rpn_cls / b, "rpn_bbox_loss": rpn_box / b, "cls_loss": cls_loss,
           "bbox_loss": bbox_loss}
    out["loss"] = sum(out[k] for k in LOSSES)
    return out


def learning_rate(ocfg, step: int) -> float:
    """The piecewise-constant schedule with its optional linear warmup."""
    lr = ocfg.base_lr if step < ocfg.lr_decay_step else ocfg.base_lr * ocfg.lr_decay_factor
    if ocfg.warmup_steps > 0:
        frac = min(step / ocfg.warmup_steps, 1.0)
        lr = min(lr, ocfg.base_lr * (ocfg.warmup_factor + (1 - ocfg.warmup_factor) * frac))
    return lr


@torch.no_grad()
def sgd_step(w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             momentum: Dict[str, torch.Tensor], step: int, ocfg, backbone: str) -> None:
    """Caffe's order: v = m v - lr (g + wd w), biases at twice the rate
    without decay, w += v for every weight the recipe does not freeze."""
    lr = learning_rate(ocfg, step)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    for name, p in w.items():
        g = grads.get(name)
        g = torch.zeros_like(p) if g is None else g
        if ocfg.clip_grad_norm > 0 and norm >= ocfg.clip_grad_norm:
            g = g / norm * ocfg.clip_grad_norm
        u = (g + ocfg.weight_decay * p) * -lr if p.dim() > 1 else g * (-2.0 * lr)
        v = momentum.setdefault(name, torch.zeros_like(p))
        v.mul_(ocfg.momentum).add_(u)
        if not is_frozen(name, backbone):
            p.add_(v)


def first_gradient(v1: torch.Tensor, p0: torch.Tensor, ocfg) -> torch.Tensor:
    """The gradient a Caffe-order step took from its weights p0 and its
    momentum after that first step, v1 = -lr (g + wd p0) (biases: -2 lr g)."""
    lr = learning_rate(ocfg, 0)
    return -v1 / lr - ocfg.weight_decay * p0 if p0.dim() > 1 else -v1 / (2.0 * lr)


def run_steps(w: Dict[str, torch.Tensor], cfg, batches: Sequence[Dict],
              props: Sequence[Tuple[np.ndarray, np.ndarray]], seed: int, dtype,
              quant: str = "none") -> Tuple[List[Dict[str, float]], Dict[str, torch.Tensor]]:
    """``len(batches)`` steps from weights ``w`` (updated in place): each
    step's losses and the first step's gradients."""
    backbone = cfg.backbone
    net = Net.for_config(w, cfg, quant)
    trainable_grad = {k for k in w if not runs_without_grad(k, backbone)}
    momentum: Dict[str, torch.Tensor] = {}
    out, first = [], {}
    for step, (batch, pr) in enumerate(zip(batches, props)):
        b, h, wd = batch["images"].shape[:3]
        a = cfg.anchors.num_anchors
        n = (h // cfg.anchors.feat_stride) * (wd // cfg.anchors.feat_stride) * a
        n_cand = cfg.proposals.post_nms_topk_train + batch["gt_boxes"].shape[1]
        mask_shape = ((b * cfg.proposal_targets.rois_per_image, cfg.head_hidden)
                      if backbone == "vgg16" else None)
        uni, masks = draws(seed, step, b, n, n_cand, mask_shape, dtype,
                           1.0 - cfg.head_dropout, batch["images"].device)
        for k in trainable_grad:
            w[k].requires_grad_(True)
        loss = losses(net, cfg, batch, pr, uni, masks)
        keys = sorted(trainable_grad)
        grads = dict(zip(keys, torch.autograd.grad(loss["loss"], [w[k] for k in keys],
                                                   allow_unused=True)))
        grads = {k: g for k, g in grads.items() if g is not None}
        for k in trainable_grad:
            w[k].requires_grad_(False)
        if step == 0:
            first = {k: g.clone() for k, g in grads.items()}
        out.append({k: float(v.detach()) for k, v in loss.items()})
        sgd_step(w, grads, momentum, step, cfg.optim, backbone)
        del loss, grads
    return out, first

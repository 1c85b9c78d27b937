"""Detection losses (port of ``trcnn/models/losses.py``).

RPN: softmax CE over the sampled anchors and smooth-L1 (sigma 3) on the
positive ones, both normalised per image by the sampled-anchor count.  Head:
softmax CE over the sampled RoIs and smooth-L1 (sigma 1) on the matched
class's deltas of the foreground rows.  Smooth-L1 is 0.5 sigma^2 x^2 where
|x| < 1/sigma^2, else |x| - 0.5/sigma^2.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def smooth_l1(x: torch.Tensor, sigma: float) -> torch.Tensor:
    sigma2 = sigma * sigma
    ax = x.abs()
    return torch.where(ax < 1.0 / sigma2, 0.5 * sigma2 * x * x, ax - 0.5 / sigma2)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy in the logsumexp form; labels integer,
    no ignore handling."""
    true_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - true_logit


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                denom: Optional[Union[float, torch.Tensor]] = None) -> torch.Tensor:
    """sum(values * mask) / max(denom, 1), denom defaulting to count(mask);
    a tensor denom (a count summed over data-parallel ranks) stays on the
    device."""
    num = torch.where(mask, values, 0.0).sum()
    if denom is None:
        denom = mask.sum().to(values.dtype)
    if torch.is_tensor(denom):
        return num / torch.clamp(denom, min=1.0)
    return num / max(float(denom), 1.0)

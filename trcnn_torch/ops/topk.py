"""Masked fixed-K top-k that carries payloads (port of ``trcnn/ops/topk.py``).

Ties go to the lower index: a stable ascending sort on the negated score,
as ``lax.sort(is_stable=True)`` gives.  ``torch.topk`` is not used because
its tie order is unspecified.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_topk_payload(scores: torch.Tensor, valid: torch.Tensor, k: int,
                        *payloads: torch.Tensor
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], torch.Tensor]:
    """Top-k over the last axis ignoring invalid entries.

    Returns (values, payloads gathered in the same order, out_valid), each
    (..., k); invalid and padding slots have value -inf.
    """
    masked = torch.where(valid, scores.float(), float("-inf"))
    neg, order = torch.sort(-masked, dim=-1, stable=True)
    values = -neg[..., :k]
    idx = order[..., :k]
    return (values, tuple(torch.gather(p, -1, idx) for p in payloads),
            values > float("-inf"))

"""The ZLPR multi-label "circle" loss (ops/loss.py of the JAX package).

Byte-identical math across the reference scripts (cmu-mosei/run.py:342-351
and friends): flip logits by label, knock out the wrong side with -1e12,
append a zero logit to each side, and sum the two logsumexps.  It is
threshold-free for multi-label training.
"""

from __future__ import annotations

import torch

_KNOCKOUT = 1e12


def zlpr_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Per-sample ZLPR loss; y_pred (..., E) float logits, y_true (..., E)
    {0, 1}, cast to the logits' dtype.  Returns (...,): the reduction is the
    caller's."""
    y_true = y_true.to(y_pred.dtype)
    flipped = (1.0 - 2.0 * y_true) * y_pred
    neg = flipped - y_true * _KNOCKOUT
    pos = flipped - (1.0 - y_true) * _KNOCKOUT
    zeros = torch.zeros_like(y_pred[..., :1])
    return (torch.logsumexp(torch.cat([neg, zeros], dim=-1), dim=-1)
            + torch.logsumexp(torch.cat([pos, zeros], dim=-1), dim=-1))

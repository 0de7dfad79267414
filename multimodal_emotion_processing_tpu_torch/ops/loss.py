"""Losses (ops/loss.py of the JAX package): the ZLPR multi-label "circle"
loss and the Ren-MME R-Drop consistency KL.

ZLPR is byte-identical math across the reference scripts
(cmu-mosei/run.py:342-351 and friends): flip logits by label, knock out the
wrong side with -1e12, append a zero logit to each side, and sum the two
logsumexps.  It is threshold-free for multi-label training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def symmetric_sigmoid_kl(logits: torch.Tensor,
                         pair_weight: torch.Tensor | None = None, *,
                         denominator: torch.Tensor | float | None = None
                         ) -> torch.Tensor:
    """The Ren-MME R-Drop consistency term (Ren-MME/run.py:332-334) over
    adjacent duplicate rows, a = logits[::2] and b = logits[1::2]:
    (KL(a ‖ b) + KL(b ‖ a)) / 2, each torch's kl_div(logsigmoid(q),
    sigmoid(p), 'batchmean') = Σ p·(log p − log q) / n_pairs over the
    element-wise sigmoid "probabilities".  p·log p is 0 where p is 0
    (p·log(max(p, 1e-38)) elsewhere, as JAX guards it).  With
    `pair_weight` (n_pairs,), 1 for a real pair and 0 for padding, the sum
    is weighted and divided by max(Σ w, 1) instead.  `denominator`
    replaces the divisor (n_pairs, or max(Σ w, 1)): on a data-parallel
    mesh the global batch's, so that the ranks' terms sum to the single
    device's."""
    a, b = logits[::2], logits[1::2]

    def kl(log_q_logits, p_logits):
        log_q = F.logsigmoid(log_q_logits)
        p = torch.sigmoid(p_logits)
        plogp = torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-38)),
                            0.0)
        elem = plogp - p * log_q
        if denominator is not None:
            if pair_weight is not None:
                elem = elem * pair_weight[:, None]
            return elem.sum() / denominator
        if pair_weight is None:
            return elem.sum() / log_q_logits.shape[0]
        return ((elem * pair_weight[:, None]).sum()
                / torch.clamp(pair_weight.sum(), min=1.0))

    return (kl(a, b) + kl(b, a)) / 2.0

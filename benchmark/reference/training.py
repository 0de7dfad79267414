"""The plain training step: the ZLPR loss, its mean over the batch's real
rows, gradients by autograd, the global-norm clip and AdamW with optax's
arithmetic (β 0.9 / 0.999, eps 1e-8 outside the square root, bias
correction 1 − β^t, decoupled decay wd·p added to the update before the
−lr scale).  A weight with no gradient counts as a zero gradient.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def zlpr(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample ZLPR: log(1 + Σ_neg e^s) + log(1 + Σ_pos e^−s)."""
    pos = labels > 0
    zero = torch.zeros_like(logits[..., :1])
    neg_part = torch.logsumexp(torch.cat(
        [logits.masked_fill(pos, float("-inf")), zero], dim=-1), dim=-1)
    pos_part = torch.logsumexp(torch.cat(
        [(-logits).masked_fill(~pos, float("-inf")), zero], dim=-1), dim=-1)
    return neg_part + pos_part


def batch_loss(logits, labels, weight: Optional[torch.Tensor] = None,
               keep_rows: Optional[int] = None) -> torch.Tensor:
    """Σ w·loss / max(Σ w, 1); `keep_rows` keeps only the first rows (a
    fault the benchmark's checks must catch: half the batch left out, the
    mean taken over the rest)."""
    per = zlpr(logits, labels)
    w = torch.ones_like(per) if weight is None else weight
    if keep_rows is not None:
        per, w = per[:keep_rows], w[:keep_rows]
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, wd)) over a list
    of f32 tensors; `first_grad` keeps the clipped gradient of step 1."""

    def __init__(self, params: List[torch.Tensor], *, lr: float, clip: float,
                 weight_decay: float):
        self.params = params
        self.lr, self.clip, self.wd = lr, clip, weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.t = 0
        self.first_grad = None

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.params)]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        scale = 1.0 if norm < self.clip else self.clip / norm
        grads = [g * scale for g in grads]
        self.t += 1
        if self.t == 1:
            self.first_grad = [g.clone() for g in grads]
        bc1, bc2 = 1.0 - B1 ** self.t, 1.0 - B2 ** self.t
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).add_(g * g, alpha=1.0 - B2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS) + self.wd * p
            p.sub_(self.lr * update)


def train_steps(forward, weights: Dict[str, torch.Tensor], batches, *,
                lr: float, clip: float, weight_decay: float,
                keep_rows: Optional[int] = None):
    """Run len(batches) steps from `weights` (copied); returns (losses,
    the clipped first gradient and the change of every weight after the
    last step, each a name -> tensor dict)."""
    names = list(weights)
    params = [weights[n].detach().clone().requires_grad_(True) for n in names]
    opt = AdamW(params, lr=lr, clip=clip, weight_decay=weight_decay)
    losses = []
    for batch in batches:
        p = dict(zip(names, params))
        loss = batch_loss(forward(p, batch), batch["label"],
                          batch.get("sample_weight"), keep_rows)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        opt.step(grads)
        losses.append(float(loss.detach()))
    return (losses, dict(zip(names, opt.first_grad)),
            {n: (p.detach() - weights[n]) for n, p in zip(names, params)})

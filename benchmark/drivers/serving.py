"""What the two serving drivers share: the seeded request pool, the
members, the sample of served requests the comparison takes, and the
plain reference of the served ensemble (the mean of the members' logits,
and sigmoid(mean − offsets) for the calibrated emotions)."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import synthetic


class Served:
    """Set-up shared by the serving cells: `pool` (host samples), the
    members from the benchmark's weights, and a log of served requests
    (pool index, logits, probabilities)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.arrays = synthetic.robot_samples(
            ctx.m, int(ctx.params["pool"]), ctx.seed_for("data"), ctx.device)
        self.pool = synthetic.as_samples(self.arrays, synthetic.ROBOT_KEYS)
        ctx.mark(f"{len(self.arrays['l'])} requests made")
        self.members, self.weights = [], []
        for i in range(int(ctx.config["members"])):
            model, w = ctx.member(f"member{i + 1}")
            self.members.append(model)
            self.weights.append(w)
        self.offsets = list(ctx.exp.thresholds)
        ctx.mark("members built")
        self.served = []          # (pool index, logits, probs)

    def outputs(self):
        rng = np.random.default_rng(self.ctx.seed_for("check"))
        k = min(int(self.ctx.params["check_requests"]), len(self.served))
        picks = np.sort(rng.choice(len(self.served), size=k, replace=False))
        idx = np.array([self.served[i][0] for i in picks])
        return {"inputs": {"weights": self.weights, "arrays": self.arrays,
                           "offsets": self.offsets, "rows": idx},
                "outputs": {"logits": np.stack([self.served[i][1] for i in picks]),
                            "probs": np.stack([self.served[i][2] for i in picks])}}

    def release(self):
        self.members = self.pool = None


def reference(ctx, prog, *, tf32: bool = False, fault=None):
    """The plain reference's served answer for each compared request, the
    members run over the requests in blocks of 16."""
    from ..core import device as card

    inputs = prog["inputs"]
    rows = np.unique(inputs["rows"])
    fwd = ctx.reference_forward()
    off = torch.tensor(inputs["offsets"], dtype=torch.float32,
                       device=ctx.device)
    out = {}
    card.set_float32(tf32)
    try:
        with torch.no_grad():
            for start in range(0, len(rows), 16):
                idx = rows[start:start + 16]
                batch = {k: torch.as_tensor(inputs["arrays"][k][idx]).to(ctx.device)
                         for k in synthetic.ROBOT_KEYS}
                lg = torch.stack([fwd(w, batch) for w in inputs["weights"]]
                                 ).mean(dim=0)
                pr = torch.sigmoid(lg[:, : off.shape[0]] - off)
                for r, a, b in zip(idx, lg.cpu().numpy(), pr.cpu().numpy()):
                    out[int(r)] = (a, b)
    finally:
        card.set_float32(False)
    return {"logits": np.stack([out[int(r)][0] for r in inputs["rows"]]),
            "probs": np.stack([out[int(r)][1] for r in inputs["rows"]])}


def compare(prog, ref) -> dict:
    """logit_err: the largest |logit − ref| over the compared requests,
    over max(1, the largest |ref|); prob_err: the largest |probability −
    ref|."""
    got = prog["outputs"]
    return {"logit_err": float(np.abs(got["logits"] - ref["logits"]).max()
                               / max(1.0, float(np.abs(ref["logits"]).max()))),
            "prob_err": float(np.abs(got["probs"] - ref["probs"]).max())}


def p95_ms(latencies_s) -> float:
    return float(np.percentile(np.asarray(latencies_s) * 1e3, 95))

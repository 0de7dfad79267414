"""Ensemble evaluation with a language model as the text tower
(`moonlight_trans`): `eval.ensemble.Ensemble(tower=)` of the
configuration's members over a host `Batcher` of a seeded split of
transcript pairs, one pass after another, each pass's combined logits
fetched to the host.  Each batch's transcripts are packed on the host,
run once through the frozen tower (models/tower.py) on the card, and each
sentence's hidden states become the members' word features.

Set-up imports the port's tower first (a program without it fails here,
at once), checks the configuration's `tower` section field by field
against the port's published settings, builds the tower on the meta
device and fills it on the card, one weight at a time, from per-tensor
sub-seeds of the run's seed (`tower_weight` says how they are drawn),
makes the split, builds
the members from the benchmark's weights, and runs one pass.  The window
runs passes until the first pass end past `--seconds`; a `--trace 1` run
traces its passes 2 to 4.

The traffic: each pair is one token sequence, the clip's transcript up to
and including the pair's two sentences, lognormal in length
(`transcript_tokens`: median, sigma, least, most), the two sentences at
its end each lognormal (`sentence_tokens`), each length the
distribution's quantiles in a seeded order; the ids uniform over the
vocabulary; video and audio as `mosei_trans`'s pairs.

End to end: `eval_samples_per_s`, pairs scored over the window's wall.
The comparison takes `check_pairs` pairs, the split's LONGEST longest
transcripts and the rest drawn from the seed: the tower's hidden states
at their sentences' tokens, those tokens' chosen experts in every MoE
layer, and the pairs' logits, from the window's first pass, against the
plain reference (reference/moonlight.py, f32, the same bf16-valued
weights made again layer by layer, then the plain reference of the
members); `compare` says which numbers.  A test may shrink the tower
through the traffic's `tower` key.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from statistics import NormalDist

import numpy as np
import torch

from ..core.harness import Window
from ..core.spec import sub_seed
from ..reference import moonlight, synthetic

TRACED_PASSES = 3
KEYS = ("tokens", "n_tokens", "sentences", "v", "v_mask", "a", "a_mask",
        "label")
FAULTS = ("top5", "no_bias", "no_shared", "cross_boundary", "no_kpe_rope",
          "partial_rows")
#: the longest transcripts of the split, compared in every run
LONGEST = 2


#: the residual stream's writers, drawn at 0.02 / √(2 · layers)
OUTPUT_PROJECTIONS = ("o_proj.weight", "down_proj.weight")


def tower_weight(seed: int, name: str, shape, device, n_layers: int
                 ) -> torch.Tensor:
    """One weight of the tower from its own sub-seed: norms 1, the routing
    correction bias N(0, 0.01²) f32, the embedding bf16 N(0, 1), the
    projections that write the residual stream (OUTPUT_PROJECTIONS) bf16
    N(0, 0.02² / (2 · n_layers)) (GPT-2's and Megatron's scaled init of
    output layers), every other weight bf16 N(0, 0.02²).  With all of
    them at 0.02 the random model is chaotic at 2,048 wide: a rounding
    anywhere changes later routing and, through attention, every later
    token, and the reference's own fp8-rounded control moved the median
    token's hidden state by 1.25 times its rms, so no limit could tell
    rounding from a fault."""
    if name.endswith("norm.weight"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "tower/" + name))
    x = torch.randn(shape, generator=g, device=device)
    if name.endswith("e_score_correction_bias"):
        return 0.01 * x
    if name == "model.embed_tokens.weight":
        return x.to(torch.bfloat16)
    std = 0.02
    if name.endswith(OUTPUT_PROJECTIONS):
        std /= (2 * n_layers) ** 0.5
    return (std * x).to(torch.bfloat16)


def tower_config(ctx):
    """(the port's TowerConfig as run, its fields as a dict): the file's
    section, checked against the port's published settings, then the
    traffic's `tower` overrides (tests only)."""
    from multimodal_emotion_processing_tpu_torch.models.tower import TOWERS

    doc = dict(ctx.config["tower"])
    name, dtype = doc.pop("name"), doc.pop("dtype")
    if dtype != "bfloat16":
        raise ValueError(f"the tower runs bf16, the file states {dtype}")
    want = dataclasses.asdict(TOWERS[name])
    if doc != want:
        diff = {k: (doc.get(k), want.get(k)) for k in set(doc) | set(want)
                if doc.get(k) != want.get(k)}
        raise ValueError(f"tower {name}: the file and the port differ "
                         f"(file, port): {diff}")
    cfg = dataclasses.replace(TOWERS[name], **ctx.params.get("tower", {}))
    return cfg, dataclasses.asdict(cfg)


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int, rng) -> np.ndarray:
    """The lognormal's n quantiles at (i + 1/2) / n, rounded and cut to
    [lo, hi], in an order drawn from `rng`: every seed draws the same
    lengths, so every seed's passes do the same work."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    out = np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)
    rng.shuffle(out)
    return out


def transcript_pairs(m, n: int, params, vocab: int, seed: int, device):
    """n pairs as host arrays keyed by KEYS: `tokens` (n, longest) int32,
    `n_tokens` (n,), `sentences` (n, 2, 2) [start, end) of the previous
    and the current sentence; video, audio and labels as
    synthetic.mosei_pairs draws them."""
    rng = np.random.default_rng(seed)
    lens = lognormal_quantiles(n, *params["transcript_tokens"], rng)
    sent = np.stack([lognormal_quantiles(n, *params["sentence_tokens"], rng)
                     for _ in range(2)], axis=1)
    lens = np.maximum(lens, sent.sum(axis=1))
    width = int(lens.max())
    tokens = rng.integers(0, vocab, size=(n, width), dtype=np.int64)
    tokens[np.arange(width)[None, :] >= lens[:, None]] = 0
    prev, cur = sent[:, 0], sent[:, 1]
    spans = np.stack([np.stack([lens - cur - prev, lens - cur], axis=1),
                      np.stack([lens - cur, lens], axis=1)], axis=1)
    out = synthetic.mosei_pairs(dataclasses.replace(m, l_dim=1), n,
                                seed ^ 0x5EED, device)
    return {"tokens": tokens.astype(np.int32), "n_tokens": lens.astype(np.int32),
            "sentences": spans.astype(np.int32), "v": out["v"],
            "v_mask": out["v_mask"], "a": out["a"], "a_mask": out["a_mask"],
            "label": out["label"]}


class Cell:
    def __init__(self, ctx):
        from multimodal_emotion_processing_tpu_torch.models.tower import (
            Tower, TowerFeed)
        from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
        from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble
        from multimodal_emotion_processing_tpu_torch.ops import moe

        self.ctx = ctx
        self.moe_kernels = moe.KERNELS
        p = ctx.params
        self.cfg, self.cfg_doc = tower_config(ctx)
        self.tower_seed = ctx.seed_for("tower")
        with torch.device("meta"):
            tower = Tower(self.cfg, dtype=torch.bfloat16)
        tower.to_empty(device=ctx.device)
        tower.fill(lambda name, shape: tower_weight(
            self.tower_seed, name, shape, ctx.device, self.cfg.num_hidden_layers))
        ctx.mark("tower made")
        n, bs = int(p["n_pairs"]), ctx.exp.train.batch_size
        self.arrays = transcript_pairs(ctx.m, n, p, self.cfg.vocab_size,
                                       ctx.seed_for("data"), ctx.device)
        self.loader = Batcher(synthetic.as_samples(self.arrays, KEYS), bs,
                              shuffle=False)
        ctx.mark(f"{n} pairs made")
        members, self.weights = [], []
        for i in range(int(ctx.config["members"])):
            model, w = ctx.member(f"member{i + 1}")
            members.append(model)
            self.weights.append(w)
        self.tower = tower
        self.ensemble = Ensemble(members, combine="mean", impl=ctx.impl,
                                 dtype=ctx.dtype,
                                 tower=TowerFeed(tower, ctx.m.l_len))
        self.bs, self.n = bs, n
        self.batches_per_pass = -(-n // bs)
        self._plan_check()
        self.logits = []
        ctx.mark("members built")
        self.ensemble.predict_all(self.loader)

    def _plan_check(self):
        """The compared pairs, and for each batch that holds one, the rows
        of the packed hidden states at their sentences' tokens."""
        rng = np.random.default_rng(self.ctx.seed_for("check"))
        k = min(int(self.ctx.params["check_pairs"]), self.n)
        n_tok, sent = self.arrays["n_tokens"], self.arrays["sentences"]
        longest = np.argsort(n_tok, kind="stable")[self.n - min(LONGEST, k):]
        drawn = rng.choice(np.setdiff1d(np.arange(self.n), longest),
                           size=k - len(longest), replace=False)
        self.pairs = np.sort(np.concatenate([longest, drawn]))
        self.rows, self.kept, self.choices = {}, {}, {}
        self.capturing, self.calls = False, 0
        for j in range(self.batches_per_pass):
            lo = j * self.bs
            cu = np.concatenate([[0], np.cumsum(n_tok[lo: lo + self.bs])])
            rows = [cu[p - lo] + np.arange(sent[p, 0, 0], sent[p, 1, 1])
                    for p in self.pairs if lo <= p < lo + self.bs]
            if rows:
                self.rows[j] = torch.as_tensor(np.concatenate(rows)).to(
                    self.ctx.device)
        self.tower.register_forward_hook(self._keep)
        for layer in self.tower.layers:
            if not layer.dense:
                layer.route = self._routing(layer.route)

    def _routing(self, route):
        """`route` keeping the compared rows' choice in the first pass."""
        def wrapped(h):
            choice, w = route(h)
            j = self.calls % self.batches_per_pass
            if self.capturing and j in self.rows:
                self.choices.setdefault(j, []).append(choice[self.rows[j]])
            return choice, w
        return wrapped

    def _keep(self, module, args, output):
        j = self.calls % self.batches_per_pass
        self.calls += 1
        if self.capturing and j in self.rows:
            self.kept[j] = output[self.rows[j]].clone()

    def outputs(self):
        hidden = torch.cat([self.kept[j] for j in sorted(self.kept)]).cpu()
        choices = torch.cat([torch.stack(self.choices[j], dim=1)
                             for j in sorted(self.kept)]).cpu()
        sent = self.arrays["sentences"]
        sizes = [int(sent[p, 1, 1] - sent[p, 0, 0]) for p in self.pairs]
        return {"inputs": {"weights": self.weights, "arrays": self.arrays,
                           "pairs": self.pairs, "tower": self.cfg_doc,
                           "tower_seed": self.tower_seed,
                           "batch_size": self.bs},
                "outputs": {"hidden": list(torch.split(hidden, sizes)),
                            "choices": list(torch.split(choices, sizes)),
                            "logits": self.logits[0][self.pairs]}}

    def release(self):
        self.ensemble = self.loader = self.tower = None
        self.rows = self.kept = self.choices = None

    def stats(self):
        return self.tower.stats().snapshot()

    def moe_launches(self):
        return {k.name: k.launches for k in self.moe_kernels}

    def edge(self, opening: bool):
        """(tower counts, expert kernel launches, tower.* span seconds) at
        an edge of the traced stretch: the port's span recorder runs
        between the two edges only."""
        from multimodal_emotion_processing_tpu_torch.utils import spans

        if opening:
            spans.drain()
            spans.enable()
            return self.stats(), self.moe_launches(), {}
        spans.disable()
        sums = Counter()
        for name, a, b, *_ in spans.drain()["spans"]:
            if name.startswith("tower."):
                sums[name] += (b - a) / 1e9
        return self.stats(), self.moe_launches(), dict(sums)


def _lengths(cell, passes: int):
    """Sequence lengths of each batch of `passes` passes."""
    n_tok = cell.arrays["n_tokens"]
    one = [n_tok[j * cell.bs:(j + 1) * cell.bs].tolist()
           for j in range(cell.batches_per_pass)]
    return one * passes


def window(cell: Cell, seconds: float, tracer) -> Window:
    from ..core import device as card
    from ..reference import tower_flops

    members = int(cell.ctx.config["members"])
    t0 = time.perf_counter()
    deadline = t0 + seconds
    before = cell.stats()
    edges = []           # Cell.edge at the traced stretch's edges
    traced = n_traced = 0
    cell.capturing = True
    while True:
        if len(cell.logits) == 1 and tracer.enabled:
            edges.append(cell.edge(True))
            tracer.start()
        cell.logits.append(cell.ensemble.predict_all(cell.loader))
        cell.capturing = False
        if tracer.active:
            traced += len(cell.logits[-1])
            n_traced += 1
        last = time.perf_counter() - tracer.overhead_s >= deadline
        if tracer.active and (n_traced == TRACED_PASSES or last):
            # a window too short for the traced passes stops at its end
            tracer.stop({"forward": Counter({cell.bs: members * n_traced
                                             * cell.batches_per_pass})})
            edges.append(cell.edge(False))
        if last:
            break
    wall = time.perf_counter() - t0 - tracer.overhead_s
    after = cell.stats()
    scored = sum(len(x) for x in cell.logits)
    failed = int(sum((~np.isfinite(x)).any(axis=1).sum() for x in cell.logits))
    stretch = tracer.summary.window_s if tracer.summary else 0.0
    passes = len(cell.logits)
    untraced = _lengths(cell, passes - n_traced)
    routed = after["routed"] - before["routed"]
    work = {"samples": scored - traced, "forwards": (scored - traced) * members,
            "passes": passes, "members": members,
            "tower_tokens": float(sum(map(sum, untraced))),
            "causal_pairs": float(sum(tower_flops.causal_pairs(b)
                                      for b in untraced)),
            "tower": cell.cfg_doc}
    if len(edges) == 2:
        (s0, l0, _), (s1, l1, span_s) = edges
        traced_routed = s1["routed"] - s0["routed"]
        routed = routed - traced_routed
        work["traced_routed"] = traced_routed.tolist()
        work["traced_lengths"] = _lengths(cell, n_traced)
        work["traced_moe_launches"] = {k: l1[k] - l0[k] for k in l1}
        work["traced_batches"] = n_traced * cell.batches_per_pass
        work["traced_span_s"] = span_s
        card.log(f"[{cell.ctx.cell.name}] traced span seconds "
                 f"{ {k: round(v, 4) for k, v in sorted(span_s.items())} }")
    # the per-layer readers divide the counts outside the traced passes
    work["routed"] = routed.tolist()
    card.log(f"[{cell.ctx.cell.name}] {passes} passes, {scored} pairs, "
             f"{after['tokens'] - before['tokens']} tokens in the window")
    return Window(metrics={"eval_samples_per_s": scored / wall},
                  wall_s=wall - stretch, work=work, attempted=scored,
                  failed=failed)


def reference(ctx, prog, *, tf32: bool = False, fault=None):
    """The plain reference's hidden states at the compared pairs' sentence
    tokens and those tokens' chosen experts (n, MoE layers, k), and the
    members' mean logits of those pairs from the program's own hidden
    states there (so `logit_err` holds the head crop and the members, and
    `hidden_err` and `flip_share` the tower).  `tf32`: the
    lower-precision control, the routed experts' inputs rounded to fp8
    e4m3 and the members' products in TF32; `fault`: one of FAULTS
    planted in the reference's tower (`cross_boundary`: each pair's
    sequence also attends to the one packed before it in its batch, the
    first of a batch to the one after it; `partial_rows`: no routed
    output in the last layer for two tokens in five, as if a kernel
    skipped some of its rows)."""
    from ..core import device as card

    inputs = prog["inputs"]
    arrays, pairs, c = inputs["arrays"], inputs["pairs"], inputs["tower"]
    dev = ctx.device
    m = ctx.m

    def seq(p):
        return torch.as_tensor(arrays["tokens"][p, : arrays["n_tokens"][p]]).to(dev)

    prefixes = None
    if fault == "cross_boundary":
        bs = inputs["batch_size"]
        prefixes = [seq(p - 1 if p % bs else p + 1) for p in pairs]

    def weight(name, shape):
        return tower_weight(inputs["tower_seed"], name, shape, dev,
                            c["num_hidden_layers"])

    def fp8(a):
        return a.to(torch.float8_e4m3fn).float()

    card.set_float32(False)
    with torch.no_grad():
        routed = []
        hidden = moonlight.forward(
            c, weight, [seq(p) for p in pairs], prefixes=prefixes, fault=fault,
            expert_input=fp8 if tf32 else (lambda a: a), choices=routed)
        sent = arrays["sentences"]
        kept = [h[int(sent[p, 0, 0]): int(sent[p, 1, 1])].cpu()
                for p, h in zip(pairs, hidden)]
        # `routed` holds each MoE layer's choice of each sequence in turn,
        # a sequence's rows after its prefix's
        n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
        choices = []
        for i, p in enumerate(pairs):
            a = 0 if prefixes is None else len(prefixes[i])
            lo, hi = a + int(sent[p, 0, 0]), a + int(sent[p, 1, 1])
            choices.append(torch.stack([routed[li * len(pairs) + i][lo:hi]
                                        for li in range(n_moe)], dim=1).cpu())
        feats, masks = [], []
        for p, h in zip(pairs, prog["outputs"]["hidden"]):
            h = h.to(dev)
            cut = int(sent[p, 0, 1] - sent[p, 0, 0])
            pair = [moonlight.head_crop(h[:cut], m.l_len),
                    moonlight.head_crop(h[cut:], m.l_len)]
            feats.append(torch.stack([f for f, _ in pair]))
            masks.append(torch.stack([mk for _, mk in pair]))
        batch = {k: torch.as_tensor(arrays[k][pairs]).to(dev)
                 for k in ("v", "v_mask", "a", "a_mask")}
        batch["l"], batch["l_mask"] = torch.stack(feats), torch.stack(masks)
        fwd = ctx.reference_forward()
        card.set_float32(tf32)
        try:
            lg = torch.stack([fwd(w, batch) for w in inputs["weights"]]).mean(dim=0)
        finally:
            card.set_float32(False)
    return {"hidden": kept, "choices": choices, "logits": lg.cpu().numpy()}


def row_errors(h, r):
    """Each token's max |h − h_ref| over rms(h_ref)."""
    h, r = h.float(), r.float()
    return (h - r).abs().amax(dim=1) / r.pow(2).mean(dim=1).sqrt()


def flipped(choice, ref_choice):
    """Each token's flag: its chosen experts (n, MoE layers, k) differ from
    the reference's as a set in some MoE layer."""
    if choice.shape != ref_choice.shape:
        return torch.ones(choice.shape[0], dtype=torch.bool)
    return (choice.sort(dim=-1).values != ref_choice.sort(dim=-1).values
            ).any(dim=-1).any(dim=-1)


def compare(prog, ref) -> dict:
    """flip_share: the share of the compared tokens whose chosen experts
    differ from the reference's in some MoE layer; hidden_err: the
    largest, over the other compared tokens, of a token's max |h − h_ref|
    over rms(h_ref); logit_err: the largest |logit − ref| over max(1, the
    largest |ref|), the reference's logits taken from the program's
    hidden states.  A routing choice near a tie goes the other way under
    bf16 rounding in about a quarter of the tokens after 26 MoE layers,
    and that token's row then moves as far as under a fault, and with it
    the summary frames' max and min (which is why the logits are compared
    from the program's hidden states); a token that chose as the
    reference did moves by bf16 rounding alone.  So a fault that changes
    the choices lifts `flip_share` above the flips' share, and one that
    leaves them fails `hidden_err` at any token it moves."""
    out = prog["outputs"]
    flips = [flipped(c, r) for c, r in zip(out["choices"], ref["choices"])]
    errs = [row_errors(h, r)[~f] for h, r, f in
            zip(out["hidden"], ref["hidden"], flips)]
    agreed = torch.cat(errs)
    got, want = out["logits"], ref["logits"]
    return {"hidden_err": float(agreed.max()) if agreed.numel() else 0.0,
            "flip_share": float(torch.cat(flips).double().mean()),
            "logit_err": float(np.abs(got - want).max()
                               / max(1.0, float(np.abs(want).max())))}

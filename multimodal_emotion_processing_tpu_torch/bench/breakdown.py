"""Train-step cost breakdown: where the milliseconds of one step go
(bench/breakdown.py of the JAX package, its ledger).

Four nested programs, each captured into a CUDA graph as the step it
models (serve/graphs.GraphedFunction, reading one batch already on the
device) and timed over its replays with utils/timing.best_window_ms, each
window ended by a host fetch of its result:

    forward            the Ensemble's captured forward (inference)
    +loss              the train-mode `engine.batch_loss` under no_grad,
                       the dropout generator registered with the capture
                       (dropout masks and the R-Drop KL term where the
                       config has them, so it nests inside the step's
                       forward)
    +backward          the loss and its gradients (`batch_loss`, then
                       `torch.autograd.grad`, the step's own gradient path
                       at accum_steps=1), no update
    +clip+optimizer    the full `engine.member_step`

and the differences between them as a ledger; then the nine (query, key)
grid streams' attention alone, each its own captured call of
`ops/attention.scored_attention` at the shapes the grid runs (f32, masks
of ones, c = 0.3; the `+sprev` variant where n_layers > 1).  Eager calls
run several times slower on the card and would measure the host, not the
step, so nothing here is timed eagerly.

    python -m multimodal_emotion_processing_tpu_torch.bench.breakdown \
        [config] [impl] [--device cpu] [--set K=V]

One JSON line on stdout; progress on stderr.
"""

from __future__ import annotations

import json
import sys


def _measure(fn, *args, steps=20, reps=4, sync_pick=None):
    from ..utils.timing import best_window_ms

    return best_window_ms(fn, *args, steps=steps, reps=reps,
                          sync_pick=sync_pick)


def stream_impl(impl: str) -> str:
    """The attention-only impl of a block impl: `pallas_fused` fuses the
    whole minus block, whose attention is scored_fwd's (`pallas`)."""
    return "pallas" if impl == "pallas_fused" else impl


def measure(name="mosei_trans", impl="xla", *, device=None, sets=(),
            steps=20, reps=4, log=None) -> dict:
    import numpy as np
    import torch

    from . import device_line, with_sets
    from .. import configs
    from ..data.loader import Batcher, to_device
    from ..data.synthetic import synthetic_dataset
    from ..eval.ensemble import Ensemble
    from ..ops.attention import scored_attention
    from ..serve.graphs import GraphedFunction
    from ..train import engine as eng
    from ..utils.device import resolve_device

    def say(msg):
        if log is not None:
            log(msg)

    dev = resolve_device(device)
    exp = with_sets(configs.get(name), sets)
    m, tcfg = exp.model, exp.train
    b = tcfg.batch_size
    samples = synthetic_dataset(name, m, b, seed=0)
    batch = to_device(next(iter(Batcher(samples, b, shuffle=False,
                                        pad_final=False,
                                        duplicate=tcfg.rdrop_kl)())), dev)
    state = eng.init_state(exp, tcfg, 0, device=dev)
    model, gen = state.model, state.generator
    params = state.optimizer.params
    timed = dict(steps=steps, reps=reps)

    ens = Ensemble([model], impl=impl, dtype=tcfg.compute_dtype)
    fwd = {k: v for k, v in batch.items() if k != "label"}

    def loss_only():
        with torch.no_grad():
            model.train()
            return eng.batch_loss(model, tcfg, batch, impl=impl, generator=gen)

    def loss_and_grads():
        model.train()
        loss = eng.batch_loss(model, tcfg, batch, impl=impl, generator=gen)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return (loss.detach(),) + tuple(g for g in grads if g is not None)

    def full_step():
        return eng.member_step(state, tcfg, batch, impl=impl)

    rows = {}
    rows["forward_ms"] = _measure(ens.logits, fwd, **timed)
    say(f"forward {rows['forward_ms']:.3f} ms")
    rows["forward_loss_ms"] = _measure(GraphedFunction(
        loss_only, dev, name="breakdown loss", generators=(gen,)), **timed)
    say(f"+loss {rows['forward_loss_ms']:.3f} ms")
    rows["forward_backward_ms"] = _measure(GraphedFunction(
        loss_and_grads, dev, name="breakdown loss+grad", generators=(gen,)),
        **timed)
    say(f"+backward {rows['forward_backward_ms']:.3f} ms")
    rows["train_step_ms"] = _measure(GraphedFunction(
        full_step, dev, name="breakdown step", generators=(gen,)), **timed)
    say(f"train step {rows['train_step_ms']:.3f} ms")

    # the nine (query, key) streams, each its own captured program at the
    # grid's shapes
    att_impl = stream_impl(impl)
    lens = {"l": m.l_len, "v": m.v_len, "a": m.a_len}
    rng = np.random.default_rng(0)
    grids = 2 if m.head == "concat_trans" else 1
    eff_b = b * (m.p_len if m.head == "state_transfer" else 1)
    c = torch.tensor([0.3], dtype=torch.float32, device=dev)

    def tensor(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    total_att = 0.0
    per_stream = {}
    for qm in ("l", "v", "a"):
        for kvm in ("l", "v", "a"):
            lq, lkv = lens[qm], lens[kvm]
            q, k, v = tensor(eff_b, lq, m.dim), tensor(eff_b, lkv, m.dim), \
                tensor(eff_b, lkv, m.dim)
            mask = torch.ones((eff_b, lkv), dtype=torch.float32, device=dev)

            def att0(q=q, k=k, v=v, mask=mask):
                with torch.no_grad():
                    return scored_attention(
                        q, k, v, mask, None, c, n_heads=m.n_heads,
                        impl=att_impl, emit_scores=m.n_layers > 1)[0]

            ms = _measure(GraphedFunction(att0, dev, name=f"{qm}<-{kvm}"),
                          **timed)
            per_stream[f"{qm}<-{kvm}"] = round(ms, 3)
            total_att += ms * grids
            if m.n_layers > 1:
                sp = tensor(eff_b, m.n_heads, lq, lkv)

                def att1(q=q, k=k, v=v, mask=mask, sp=sp):
                    with torch.no_grad():
                        return scored_attention(q, k, v, mask, sp, c,
                                                n_heads=m.n_heads,
                                                impl=att_impl)[0]

                ms1 = _measure(GraphedFunction(
                    att1, dev, name=f"{qm}<-{kvm}+sprev"), **timed)
                per_stream[f"{qm}<-{kvm}+sprev"] = round(ms1, 3)
                total_att += ms1 * (m.n_layers - 1) * grids
    say(f"attention streams {total_att:.3f} ms")

    d = rows
    return {
        "config": name, "impl": impl, "batch": b,
        "forward_ms": round(d["forward_ms"], 2),
        "loss_delta_ms": round(d["forward_loss_ms"] - d["forward_ms"], 2),
        "backward_delta_ms": round(
            d["forward_backward_ms"] - d["forward_loss_ms"], 2),
        "optimizer_delta_ms": round(
            d["train_step_ms"] - d["forward_backward_ms"], 2),
        "train_step_ms": round(d["train_step_ms"], 2),
        "attention_only_sum_ms": round(total_att, 2),
        "attention_streams_ms": per_stream,
        "attention_impl": att_impl,
        "device": device_line(dev),
        "note": ("each program is captured into a CUDA graph and timed over "
                 "its replays the same way, so the card's launch and "
                 "replay cost (one graph launch and the host fetch that "
                 "ends each window) cancels in the *_delta_ms terms; "
                 "loss_delta_ms also carries dropout-mask and R-Drop-KL "
                 "cost for configs that have them (the train-mode forward "
                 "vs the inference forward); attention_only_sum_ms sums "
                 "standalone replays (sprev-free for layer 0, +sprev "
                 "variants for deeper layers) x grids and carries the "
                 "replay cost many times: an upper bound"),
    }


def main(argv=None):
    from . import entry_parser

    ap = entry_parser("train-step cost ledger of one config")
    ap.add_argument("config", nargs="?", default="mosei_trans")
    ap.add_argument("impl", nargs="?", default="xla")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    ledger = measure(args.config, args.impl, device=args.device,
                     sets=args.set, steps=args.steps, reps=args.reps,
                     log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(ledger), flush=True)
    return ledger


if __name__ == "__main__":
    main()

"""Parameter counts of a port model (utils/__init__.py of the JAX
package)."""

from __future__ import annotations


def parameter_count(model) -> dict:
    """Total and trainable parameter counts (the reference's
    get_parameter_number, cmu-mosei/run.py:201-204): every parameter is
    trainable, in the reference and in both packages, and the total is
    the JAX package's for the same config."""
    total = sum(p.numel() for p in model.parameters())
    return {"Total": int(total), "Trainable": int(total)}


def parameter_breakdown(model, depth: int = 2) -> dict:
    """Per-module parameter counts: `named_parameters()` grouped by the
    first `depth` dotted segments of their names, in the module's order.
    The keys are the reference's state-dict names (`intensity.
    multimodal_blocks`, ...), not the JAX package's pytree paths
    (`intensity/blocks`, ...), so the groups differ from JAX's while the
    total is the same."""
    out: dict = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:depth]) or "<root>"
        out[key] = out.get(key, 0) + int(p.numel())
    return out

"""The inference half of the engine: the compute-dtype casts around a
forward (train/engine.py:328-344 of the JAX package).  The train step is a
later slice."""

from __future__ import annotations

import copy

import torch

# loss-side weight vectors stay f32 (batch_loss's keep-set)
_KEEP_F32 = {"sample_weight", "clip_mask"}


def infer_cast(model, batch, dtype: str):
    """bf16 compute for the inference path: returns (model, batch) with the
    parameters and every floating batch entry outside the keep-set at
    bfloat16.  The model is copied, so the caller's stays f32; either of
    the two may be None.  "float32" returns both unchanged.  The logit
    upcast is the caller's job (`infer_upcast`), so score and threshold math
    never runs in bf16."""
    if dtype == "float32":
        return model, batch
    if dtype != "bfloat16":
        raise ValueError(f"compute dtype {dtype!r}: expected float32 or bfloat16")
    if model is not None:
        model = copy.deepcopy(model).to(torch.bfloat16)
    if batch is not None:
        batch = {k: (v if k in _KEEP_F32 or not v.is_floating_point()
                     else v.to(torch.bfloat16))
                 for k, v in batch.items()}
    return model, batch


def infer_upcast(logits: torch.Tensor) -> torch.Tensor:
    return logits.float() if logits.dtype == torch.bfloat16 else logits

"""The benchmark's yardstick: plain PyTorch and NumPy, independent of the
program it measures.  Nothing here imports the port
(`multimodal_emotion_processing_tpu_torch`), the JAX package or JAX.

- `synthetic`: the traffic's samples (frozen copies of the port's samplers
  and bulk generators of the same distributions);
- `weights`: every model weight, made from the seed on the device;
- `models`: the plain forward of each configuration's model;
- `training`: the plain ZLPR loss, clip and AdamW step;
- `flops`, `roofline`: operation and byte counts, the card's peaks;
- `profile`: the device busy / idle arithmetic of a profiled window.
"""

"""PyTorch + CUDA port of multimodal_emotion_processing_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports nothing of
it and nothing of JAX.
"""

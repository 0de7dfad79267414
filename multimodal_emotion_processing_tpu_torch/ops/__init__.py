"""The port's attention, loss and pooling ops and their CUDA kernels;
`cp_context` binds the ranks that `impl="cp"` attention runs over."""

from .context_parallel import cp_context  # noqa: F401

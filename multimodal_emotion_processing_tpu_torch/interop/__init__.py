from .torch_compat import from_jax_params  # noqa: F401

from .torch_compat import (from_jax_params, load_reference_checkpoint,  # noqa: F401
                           to_reference_state_dict)

"""Data and tensor parallelism over torch.distributed (parallel/ of the
JAX package): `mesh.py` (the mesh, batch slicing, the tensor-parallel
placement, the data-parallel step's pieces) and `comm.py` (the
collectives and their autograd functions)."""

from .mesh import (  # noqa: F401
    DataParallel, Mesh, TensorParallel, WholeState, initialize_multihost,
    is_rank0, local_device, make_mesh, place_state, process_batch_slice,
    put_global_batch, shard_params, tp_param_spec, world, world_mesh,
)

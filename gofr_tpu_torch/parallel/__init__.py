"""Parallelism: serving meshes and the placement of the model over them.

Port of ``gofr_tpu/parallel/``'s serving half. The JAX package serves a
mesh from one process (GSPMD inserts the collectives); the port keeps that
single controller: one process holds the mesh's devices, shards the
weights, the KV and the pool's slots over dp, fsdp and tp, and runs the
reduces itself (``parallel/serving.py``). Ring, Ulysses, pipeline and
expert parallelism and the multihost runtime are training-side and wait
for their slices (ROADMAP §A2).
"""

from gofr_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    axis_size,
    make_mesh,
    mesh_axes,
    mesh_shape_for,
    visible_devices,
)
from gofr_tpu_torch.parallel.sharding import (
    ShardedKV,
    batch_spec,
    cache_specs,
    kv_arena_spec,
    param_specs,
    shard_params,
)

__all__ = [
    "AXES", "Mesh", "make_mesh", "mesh_shape_for", "axis_size", "mesh_axes", "visible_devices",
    "param_specs", "batch_spec", "cache_specs", "kv_arena_spec", "shard_params", "ShardedKV",
]

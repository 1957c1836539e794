"""Parallelism: device meshes, the placement of the model over them, and
the sequence- and pipeline-parallel forwards.

Port of ``gofr_tpu/parallel/``. The JAX package drives a mesh from one
process (GSPMD inserts the collectives); the port keeps that single
controller for serving and training alike: one process holds the mesh's
devices, shards the weights (and, serving, the KV and the pool's slots)
over dp, fsdp and tp and runs the reduces itself (``parallel/serving.py``;
training through ``training/trainer.py::place_train_state``, where autograd
carries the gradients' collectives). ``ring.py`` and ``ulysses.py`` split
the sequence over sp, ``pipeline.py`` the layers over pp, ``expert.py``
the MoE experts over ep. ``multihost.py`` joins the process group of a
multi-host deployment (``torch.distributed``).
"""

from gofr_tpu_torch.parallel.expert import (
    make_moe_forward,
    make_moe_loss,
    moe_param_specs,
    place_moe_params,
)
from gofr_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    axis_size,
    make_mesh,
    mesh_axes,
    mesh_shape_for,
    visible_devices,
)
from gofr_tpu_torch.parallel.pipeline import (
    make_pipeline_forward,
    make_pipeline_loss,
    pipeline_param_specs,
    place_pipeline_params,
)
from gofr_tpu_torch.parallel.ring import make_ring_forward, make_ring_loss, ring_attention
from gofr_tpu_torch.parallel.sharding import (
    ShardedKV,
    batch_spec,
    cache_specs,
    kv_arena_spec,
    param_specs,
    shard_params,
)
from gofr_tpu_torch.parallel.ulysses import (
    make_ulysses_forward,
    make_ulysses_loss,
    ulysses_attention,
)

__all__ = [
    "AXES", "Mesh", "make_mesh", "mesh_shape_for", "axis_size", "mesh_axes", "visible_devices",
    "param_specs", "batch_spec", "cache_specs", "kv_arena_spec", "shard_params", "ShardedKV",
    "ring_attention", "make_ring_forward", "make_ring_loss",
    "ulysses_attention", "make_ulysses_forward", "make_ulysses_loss",
    "make_pipeline_forward", "make_pipeline_loss", "place_pipeline_params",
    "pipeline_param_specs",
    "make_moe_forward", "make_moe_loss", "moe_param_specs", "place_moe_params",
]

"""Data-parallel training and serving on ``torch.distributed`` (port of
``endosurf_tpu/parallel``): the runtime (``distributed``) and the ray-axis
sharding, reductions and gathers (``mesh``)."""

from endosurf_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    gather_rows,
    make_mesh,
    shard_ray_batch,
)

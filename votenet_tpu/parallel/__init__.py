"""Parallelism: device mesh construction and data-parallel sharding.

The reference is strictly single-GPU (SimpleTrainer, run.py:136; SURVEY
§2.3); its only parallelism is multi-process host data loading over ZMQ.
The equivalents here are first-class:

- a ``jax.sharding.Mesh`` over the batch axis; gradients/batch-norm
  statistics all-reduce between devices via collectives XLA inserts under
  GSPMD;
- per-host input sharding helpers for multi-host pods;
- point-axis (SP) sharding for the O(N) irregular ops — scale the point
  count over a mesh axis with bit-exact semantics
  (:mod:`votenet_tpu.parallel.point_sharded`);
- everything works identically on a virtual CPU mesh
  (``--xla_force_host_platform_device_count``) for testing.
"""

from votenet_tpu.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
from votenet_tpu.parallel.point_sharded import (
    farthest_point_sample_sharded,
    gather_point_sharded,
    group_point_sharded,
    point_sharding,
    query_ball_point_sharded,
    sample_and_group_sharded,
    three_nn_sharded,
)

__all__ = [
    "make_mesh", "batch_sharding", "replicated_sharding", "shard_batch",
    "point_sharding", "query_ball_point_sharded", "three_nn_sharded",
    "group_point_sharded", "gather_point_sharded",
    "farthest_point_sample_sharded", "sample_and_group_sharded",
]

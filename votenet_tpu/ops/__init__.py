"""Core point-cloud ops: JAX equivalents of the reference's tf_ops.

Each op exists as a pure-XLA implementation (`jnp`/`lax`, runs on any
backend, serves as the correctness oracle) and — for FPS and ball query —
a Pallas-Triton GPU kernel in :mod:`votenet_tpu.ops.pallas` selected via
:func:`votenet_tpu.ops.dispatch.use_gpu_kernels`.

Reference mapping (all fixed-shape here; the reference returns
variable-length from NMS):

====================  ==========================================
this module           reference
====================  ==========================================
farthest_point_sample tf_ops/sampling/tf_sampling.py:48 (CUDA)
gather_point          tf_ops/sampling/tf_sampling.py:29 (CUDA)
prob_sample           tf_ops/sampling/tf_sampling.py:50 (CUDA)
query_ball_point      tf_ops/grouping/tf_grouping.py:8  (CUDA)
group_point           tf_ops/grouping/tf_grouping.py:33 (CUDA)
knn_point             tf_ops/grouping/tf_grouping.py:48
select_top_k          tf_ops/grouping/tf_grouping.py:22 (CUDA)
three_nn              tf_ops/3d_interpolation/tf_interpolate.py:8 (CPU C++)
three_interpolate     tf_ops/3d_interpolation/tf_interpolate.py:19 (CPU C++)
nms3d                 tf_ops/3d_nms/tf_nms3d.py:11 (CPU C++)
====================  ==========================================
"""

from votenet_tpu.ops.dispatch import pallas_disabled, set_use_pallas, use_gpu_kernels
from votenet_tpu.ops.sampling import farthest_point_sample, gather_point, prob_sample
from votenet_tpu.ops.grouping import (
    query_ball_point,
    query_ball_point_dense,
    query_ball_point_streaming,
    group_point,
    knn_point,
    select_top_k,
)
from votenet_tpu.ops.interpolate import (
    three_nn,
    three_nn_dense,
    three_nn_streaming,
    three_interpolate,
)
from votenet_tpu.ops.iou3d import box3d_iou_pairwise, box3d_iou_matrix
from votenet_tpu.ops.nms3d import nms3d, nms3d_indices

__all__ = [
    "farthest_point_sample", "gather_point", "prob_sample",
    "query_ball_point", "query_ball_point_dense", "query_ball_point_streaming",
    "group_point", "knn_point", "select_top_k",
    "three_nn", "three_nn_dense", "three_nn_streaming", "three_interpolate",
    "box3d_iou_pairwise", "box3d_iou_matrix",
    "nms3d", "nms3d_indices",
    "use_gpu_kernels", "set_use_pallas", "pallas_disabled",
]

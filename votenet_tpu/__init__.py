"""votenet_tpu — a JAX (XLA / Pallas / pjit) VoteNet framework for NVIDIA GPUs.

A from-scratch rebuild of the capabilities of qq456cvb/VoteNet (TF1.x /
Tensorpack / CUDA reference at /root/reference):

- the reference's four native op packages (``tf_ops/sampling``,
  ``tf_ops/grouping``, ``tf_ops/3d_interpolation``, ``tf_ops/3d_nms``)
  become fixed-shape, mask-based XLA ops plus Pallas-Triton GPU kernels
  (:mod:`votenet_tpu.ops`);
- the Tensorpack model / trainer / callback stack becomes a functional
  JAX model (:mod:`votenet_tpu.models`), a jit/pjit training harness
  (:mod:`votenet_tpu.train`) and a batched evaluator
  (:mod:`votenet_tpu.eval`);
- single-GPU execution becomes data-parallel execution over a
  ``jax.sharding.Mesh`` (:mod:`votenet_tpu.parallel`).
"""

from votenet_tpu.config import Config, default_config, tiny_config

__version__ = "0.1.0"

__all__ = ["Config", "default_config", "tiny_config", "VoteNetPredictor", "__version__"]


def __getattr__(name):
    # lazy: keep `import votenet_tpu` cheap (no jax import at top level)
    if name == "VoteNetPredictor":
        from votenet_tpu.predictor import VoteNetPredictor

        return VoteNetPredictor
    raise AttributeError(name)

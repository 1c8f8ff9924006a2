"""Pallas-Triton kernels for the hot point-cloud ops on NVIDIA GPUs.

Each kernel has an XLA twin in :mod:`votenet_tpu.ops` with identical
semantics (the twins are the correctness oracles; the CPU tests run the
kernels in interpret mode against them and the numpy oracles).
:mod:`votenet_tpu.ops.dispatch` picks the kernel on GPU backends and the
twin elsewhere.
"""


def gpu_available() -> bool:
    """True when the default JAX backend is a GPU."""
    import jax

    return jax.default_backend() == "gpu"

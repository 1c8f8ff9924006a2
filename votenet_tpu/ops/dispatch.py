"""Backend dispatch: GPU kernels vs their XLA twins.

The hot ops with a hand-written kernel (farthest-point sampling, ball query)
have two implementations with identical semantics: a Pallas-Triton kernel
(:mod:`votenet_tpu.ops.pallas`) and a pure-XLA twin that runs on any backend
and serves as the correctness oracle. This module owns the choice:

- :func:`use_gpu_kernels` — True iff the kernels should be used right now
  (enabled AND the default backend is a GPU). Ops consult this at trace
  time; on the CPU, where the tests run, it is always False.
- :func:`set_use_pallas` — flip the global switch; ``Config.use_pallas`` is
  applied through this by the training/eval entry points, so
  ``--use_pallas=False`` forces the XLA twins on the GPU (A/B timing).
- :func:`pallas_disabled` — context manager for tests/debugging.

The reference has no equivalent (its CUDA ops are the only implementation).
"""

from __future__ import annotations

import contextlib

_enabled: bool = True


def set_use_pallas(enabled: bool) -> None:
    """Globally enable/disable the GPU kernels (XLA twins used when False)."""
    global _enabled
    _enabled = bool(enabled)


def use_gpu_kernels() -> bool:
    """True iff ops should dispatch to the GPU kernels for this trace."""
    from votenet_tpu.ops.pallas import gpu_available

    return _enabled and gpu_available()


@contextlib.contextmanager
def pallas_disabled():
    """Force the XLA twins within the context (regardless of backend)."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


# --- ball-query distance precision (query_ball_point hit test) ---
#
# "exact":     the strict hit test uses the exact difference-square distance
#              form (the oracle's own formula): index/count outputs are
#              bit-identical to the reference semantics by construction.
#              Default: grouped features feed everything downstream.
# "fast_bf16": the |a|^2+|b|^2-2ab matmul expansion at default matmul
#              precision, whose rounding of the coordinate operands moves
#              the ball boundary by centimetres at room scale; not parity,
#              and always the XLA twin (see ops/grouping.py).
_bq_precision: str = "exact"


def set_bq_precision(mode: str) -> None:
    """Set the ball-query distance mode ("exact" | "fast_bf16")."""
    global _bq_precision
    if mode not in ("exact", "fast_bf16"):
        raise ValueError(f"bq_precision must be 'exact' or 'fast_bf16', got {mode!r}")
    _bq_precision = mode


def bq_precision() -> str:
    """Current ball-query distance precision mode (read per call, outside
    the op's jit cache, so flipping it takes effect immediately)."""
    return _bq_precision


# --- SA-layer gather transport packing (train fused path) ---
#
# "none":      the fused [xyz ‖ feat] group gather moves f32 rows — every
#              transported bit of the reference path. Default.
# "bf16_hilo": the gather TABLE is packed bf16 — coordinates as a Dekker-
#              style hi+lo bf16 pair (hi = bf16(x), lo = bf16(x - f32(hi)):
#              ~16 mantissa bits ≈ 0.06 mm at room scale) and features
#              bf16-rounded — so the (B, M, S, 3+C) grouped tensor moves
#              (6+C)*2 bytes/row instead of (3+C)*4. Compute stays f32: the
#              packed channels are upcast in the consumer matmul's operand
#              read (CenteredDense split path). Applies only to backbone SA
#              layers (coord_grad=False, points present): coordinate
#              gradients never touch bf16. ~0.4% relative rounding on sa2+
#              features and their gradients.
_gather_packing: str = "none"


def set_gather_packing(mode: str) -> None:
    """Set the SA-layer gather transport packing ("none" | "bf16_hilo")."""
    global _gather_packing
    if mode not in ("none", "bf16_hilo"):
        raise ValueError(
            f"gather_packing must be 'none' or 'bf16_hilo', got {mode!r}"
        )
    _gather_packing = mode


def gather_packing() -> str:
    """Current gather transport packing mode (consulted at trace time)."""
    return _gather_packing


def apply_config(config) -> None:
    """Apply every dispatch-relevant Config knob (entry-point helper)."""
    set_use_pallas(config.use_pallas)
    set_bq_precision(config.bq_precision)
    set_gather_packing(config.gather_packing)

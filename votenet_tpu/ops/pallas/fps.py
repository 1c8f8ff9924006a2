"""Farthest-point sampling as one Pallas-Triton kernel for NVIDIA GPUs.

The XLA twin (:func:`votenet_tpu.ops.sampling.farthest_point_sample_xla`)
runs each of the ``npoint - 1`` serial selection steps as several small
device kernels (gather, distance+min, argmax, update), so it is bound by
launch latency. This kernel keeps the whole selection loop inside one
launch, as the reference CUDA kernel does (tf_sampling_g.cu:105-170): one
program per batch row, the per-point running min-distance kept on the
device (a scratch row that stays in L1/L2) and a block-wide max-reduce per
step.

Each step streams the row in chunks of ``chunk`` points. Per lane it keeps
the largest min-distance seen and its lowest chunk (strict ``>``), then one
max and one min reduce pick the largest distance with the lowest index:
the reference's strictly-greater scan and ``jnp.argmax``'s tie-break.

The squared distance is rounded exactly as the numpy oracle rounds it,
``((dx*dx) + (dy*dy)) + (dz*dz)``: on the GPU the products are
``mul.rn.f32`` (inline PTX), which the compiler never contracts into an FMA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_MAX_CHUNK = 4096  # points per streamed chunk (a power of two, Triton's rule)
_UNROLL_CHUNKS = 16  # rows of up to 16 chunks unroll the chunk loop


def mul_rn(a: jnp.ndarray, b: jnp.ndarray, interpret: bool) -> jnp.ndarray:
    """IEEE round-to-nearest product that the GPU compiler cannot fuse into
    an FMA with a following add (interpret mode: the plain product)."""
    if interpret:
        return a * b
    (p,) = plgpu.elementwise_inline_asm(
        "mul.rn.f32 $0, $1, $2;",
        args=[a, b],
        constraints="=f,f,f",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.float32)],
    )
    return p


def sqdist3(dx, dy, dz, interpret: bool):
    """``((dx*dx) + (dy*dy)) + (dz*dz)`` with unfused products."""
    return (
        mul_rn(dx, dx, interpret) + mul_rn(dy, dy, interpret)
    ) + mul_rn(dz, dz, interpret)


def chunk_loop(nchunks: int, body, carry):
    """Run ``body(c, carry)`` over chunks ``c`` in order: unrolled (static
    offsets) for short rows, a device loop for long ones."""
    if nchunks <= _UNROLL_CHUNKS:
        for c in range(nchunks):
            carry = body(c, carry)
        return carry
    return lax.fori_loop(0, nchunks, body, carry)


def fps_chunk(n: int) -> int:
    """Chunk width for an ``n``-point row: the next power of two, capped."""
    return min(_MAX_CHUNK, pl.next_power_of_2(max(n, 16)))


def _fps_kernel(
    npoint: int, n_valid: int, chunk: int, nchunks: int, interpret: bool,
    x_ref, y_ref, z_ref,  # (Np,) coordinate planes of one batch row
    o_ref,                # (npoint,) int32 selected indices
    mind_ref,             # (Np,) f32 running min-distance (scratch output)
):
    lane = lax.broadcasted_iota(jnp.int32, (chunk,), 0)

    def start(c):
        return c * chunk if isinstance(c, int) else pl.multiple_of(c * chunk, chunk)

    def init(c, carry):
        # padding can never win: real points always have mindist >= 0
        valid = start(c) + lane < n_valid
        mind_ref[pl.ds(start(c), chunk)] = jnp.where(
            valid, jnp.float32(1e38), jnp.float32(-1.0)
        )
        return carry

    chunk_loop(nchunks, init, 0)
    o_ref[0] = jnp.int32(0)  # the reference seeds FPS at index 0

    def step(j, last):
        x1, y1, z1 = x_ref[last], y_ref[last], z_ref[last]

        def scan_chunk(c, carry):
            bestv, besti = carry
            sl = pl.ds(start(c), chunk)
            d = sqdist3(x_ref[sl] - x1, y_ref[sl] - y1, z_ref[sl] - z1, interpret)
            md = jnp.minimum(mind_ref[sl], d)
            mind_ref[sl] = md
            better = md > bestv  # strict: an earlier chunk keeps a tie
            return (
                jnp.where(better, md, bestv),
                jnp.where(better, start(c) + lane, besti),
            )

        bestv, besti = chunk_loop(
            nchunks,
            scan_chunk,
            (jnp.full((chunk,), -2.0, jnp.float32), jnp.zeros((chunk,), jnp.int32)),
        )
        best = jnp.max(bestv)
        nxt = jnp.min(jnp.where(bestv == best, besti, jnp.int32(2**31 - 1)))
        o_ref[j] = nxt
        return nxt

    lax.fori_loop(1, npoint, step, jnp.int32(0))


@functools.partial(jax.jit, static_argnums=(0, 2))
def farthest_point_sample_gpu(
    npoint: int, xyz: jnp.ndarray, interpret: bool = False
) -> jnp.ndarray:
    """Pallas-Triton FPS: (B, N, 3) -> (B, npoint) int32, seed index 0.

    Same semantics as the XLA twin and the numpy oracle, bit for bit.
    ``interpret=True`` runs the kernel on the CPU (tests).
    """
    xyz = lax.stop_gradient(xyz.astype(jnp.float32))
    B, N, _ = xyz.shape
    chunk = fps_chunk(N)
    nchunks = -(-N // chunk)
    Np = nchunks * chunk
    planes = jnp.pad(jnp.transpose(xyz, (2, 0, 1)), ((0, 0), (0, 0), (0, Np - N)))
    row = pl.BlockSpec((None, Np), lambda b: (b, 0))
    idx, _ = pl.pallas_call(
        functools.partial(_fps_kernel, npoint, N, chunk, nchunks, interpret),
        grid=(B,),
        in_specs=[row, row, row],
        out_specs=(pl.BlockSpec((None, npoint), lambda b: (b, 0)), row),
        out_shape=(
            jax.ShapeDtypeStruct((B, npoint), jnp.int32),
            jax.ShapeDtypeStruct((B, Np), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(16, chunk // 256)), num_stages=1
        ),
        interpret=interpret,
        name="fps",
    )(planes[0], planes[1], planes[2])
    return idx

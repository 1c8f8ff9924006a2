"""Convergence A/B for the packed bf16 hi/lo SA-gather transport.

Trains the full model for STEPS steps (synthetic scenes, fixed seed,
identical init and batch order) under gather_packing in {none, bf16_hilo}
and prints the loss trajectory side by side. The packed mode's only
numerics change is the forward transport cast of the sa2+ grouped
features (DESIGN.md "packed bf16 hi/lo gather transport"); this script
is the empirical check that the cast does not bend the optimization
path at the loss-curve level.

Run on the GPU: python benchmarks/packed_gather_curve.py [STEPS]
"""

from __future__ import annotations

import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

TINY = os.environ.get("CURVE_TINY", "") == "1"  # CPU smoke of the harness
STEPS = int(sys.argv[1]) if len(sys.argv) > 1 else (8 if TINY else 2000)
B = 2 if TINY else 8
REPORT_EVERY = min(4 if TINY else 200, STEPS)  # never exceed STEPS (a short
# CLI run must still produce >=1 report chunk); STEPS is rounded UP to a
# whole number of chunks below so no requested steps are silently dropped
N_CHUNKS = max(1, -(-STEPS // REPORT_EVERY))


def main():
    from votenet_tpu.config import default_config, tiny_config
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.ops import dispatch
    from votenet_tpu.train.loop import make_train_step
    from votenet_tpu.train.state import create_train_state

    cfg = (tiny_config() if TINY else default_config()).replace(batch_size=B)
    model = VoteNet(cfg)

    # One fixed epoch of batches, replayed in the same order for both arms.
    # Stack straight from the batch iterator (no intermediate list of device
    # arrays — the stacked epoch alone is ~250 MB at full size) and pass it
    # as an explicit jit ARGUMENT: captured as a trace constant it would be
    # baked into both arms' executables, holding the data twice on device.
    scenes = list(synthetic_scenes(0, cfg, 8 if TINY else 512))
    per_key = {}
    n_batches = 0
    for b in batch_scenes(iter(scenes), B, cfg.max_gt_boxes):
        for k, v in b.items():
            per_key.setdefault(k, []).append(np.asarray(v))
        n_batches += 1
    stacked = {k: jnp.asarray(np.stack(v)) for k, v in per_key.items()}
    del per_key

    curves = {}
    for pack in ("none", "bf16_hilo"):
        # The gather_packing mode is consulted at TRACE time
        # (ops.dispatch.gather_packing() inside the SA module), so each arm
        # MUST re-jit from scratch — reusing a compiled step across arms
        # would silently run identical numerics. A fresh `chunk` closure per
        # arm gives jax a fresh pjit cache entry.
        dispatch.set_gather_packing(pack)
        step = make_train_step(model, cfg)
        state = create_train_state(jax.random.PRNGKey(0), cfg,
                                   steps_per_epoch=n_batches)

        @functools.partial(jax.jit, donate_argnums=0)
        def chunk(s, data, lo):
            def body(i, carry):
                c, acc = carry
                batch = jax.tree_util.tree_map(
                    lambda x: x[(lo + i) % n_batches], data
                )
                c2, metrics = step(c, batch)
                return c2, acc + metrics["total_cost"]
            return lax.fori_loop(0, REPORT_EVERY, body, (s, jnp.float32(0.0)))

        losses = []
        for k in range(N_CHUNKS):
            state, tot = chunk(state, stacked, k * REPORT_EVERY)
            losses.append(float(tot) / REPORT_EVERY)
            print(f"pack={pack:9s} step {(k + 1) * REPORT_EVERY:5d}: "
                  f"mean total_cost {losses[-1]:.4f}", flush=True)
        curves[pack] = losses

    dispatch.set_gather_packing("none")
    a, b = np.asarray(curves["none"]), np.asarray(curves["bf16_hilo"])
    print("\nstep      none   bf16_hilo   delta")
    for i, (x, y) in enumerate(zip(a, b)):
        print(f"{(i + 1) * REPORT_EVERY:5d}  {x:8.4f}  {y:8.4f}  {y - x:+8.4f}")
    print(f"\nmax |delta| {np.max(np.abs(a - b)):.4f}, "
          f"final delta {b[-1] - a[-1]:+.4f} "
          f"({100 * (b[-1] - a[-1]) / a[-1]:+.2f}%)")


if __name__ == "__main__":
    main()

"""Two-process distributed training smoke (VERDICT r2 #5).

Everything multi-host in this framework — ``host_local_slice`` input
sharding, per-process steps_per_epoch, the sharded train step — was only
ever exercised inside ONE process with a virtual device mesh. This smoke
actually runs TWO OS processes, each owning 4 virtual CPU devices, joined
via ``jax.distributed.initialize`` (Gloo collectives over localhost — the
same code path a multi-host cluster takes over its network, SURVEY §2.3).
The processes run with ``JAX_PLATFORMS=cpu``: several JAX processes must
not share one GPU (each reserves most of its memory at start-up).

- asserts the global device view (8 devices, 4 local) from both processes;
- partitions the scene ids with the production ``host_local_slice`` and
  asserts equal per-process counts (the SPMD-desync fix);
- builds the global batch with ``jax.make_array_from_process_local_data``
  (each process contributes only ITS slice's scenes);
- runs ONE jitted data-parallel VoteNet train step over the global mesh and
  prints the (replicated) loss — the parent asserts both processes report
  the same value, proving the gradient all-reduce ran across processes.

Run:  python benchmarks/multiprocess_smoke.py            # parent: spawns 2
      python benchmarks/multiprocess_smoke.py --child I  # internal
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NPROC = 2
DEV_PER_PROC = 4
N_SCENES = 8


def child(pid: int) -> None:
    import jax

    port = int(os.environ["SMOKE_PORT"])
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=NPROC, process_id=pid
    )
    assert jax.process_index() == pid
    assert jax.process_count() == NPROC
    assert jax.device_count() == NPROC * DEV_PER_PROC
    assert jax.local_device_count() == DEV_PER_PROC

    import jax.numpy as jnp
    import numpy as np

    from votenet_tpu.config import tiny_config
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.parallel.mesh import (
        batch_sharding,
        host_local_slice,
        make_mesh,
        replicated_sharding,
    )
    from votenet_tpu.train.loop import make_train_step
    from votenet_tpu.train.state import create_train_state

    cfg = tiny_config(batch_size=N_SCENES)
    # every process generates the same global scene set deterministically,
    # then loads ONLY its host_local_slice (the per-host input pipeline)
    scenes = synthetic_scenes(0, cfg, N_SCENES)
    local_ids = host_local_slice(list(range(N_SCENES)))
    print(f"proc {pid} slice={local_ids}", flush=True)
    assert len(local_ids) == N_SCENES // NPROC

    local_batch = next(iter(batch_scenes(
        iter([scenes[i] for i in local_ids]), len(local_ids), cfg.max_gt_boxes
    )))

    mesh = make_mesh()  # all 8 global devices, 1-D "data"
    assert mesh.size == NPROC * DEV_PER_PROC
    data_sh = batch_sharding(mesh)
    repl = replicated_sharding(mesh)

    # global batch: each process contributes its local shard
    global_batch = {
        k: jax.make_array_from_process_local_data(data_sh, np.asarray(v))
        for k, v in local_batch.items()
    }
    for v in global_batch.values():
        assert v.shape[0] == N_SCENES  # global leading axis

    state = create_train_state(jax.random.PRNGKey(0), cfg, steps_per_epoch=2)
    model = VoteNet(cfg)
    step = jax.jit(
        make_train_step(model, cfg),
        in_shardings=(repl, data_sh),
        out_shardings=(repl, repl),
    )
    new_state, metrics = step(state, global_batch)
    # fetching a replicated scalar is process-local; both processes must see
    # the identical all-reduced loss
    print(f"proc {pid} total_cost={float(metrics['total_cost']):.6f}", flush=True)
    print(f"proc {pid} step={int(new_state.step)}", flush=True)
    jax.distributed.shutdown()


def _free_port() -> int:
    """Ask the kernel for a currently-free TCP port (beats a pinned port,
    which flaked in full-suite runs when a previous listener lingered)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parent() -> int:
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")
    }
    env.update({
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": REPO,
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={DEV_PER_PROC}",
        "SMOKE_PORT": os.environ.get("SMOKE_PORT") or str(_free_port()),
    })
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(NPROC)
    ]
    outs = []
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        outs.append(out)
        print(f"--- proc {i} (rc={p.returncode}) ---\n{out}", flush=True)
        if p.returncode != 0:
            return 1

    # cross-process assertions
    import re

    slices, costs = [], []
    for out in outs:
        slices.append(eval(re.search(r"slice=(\[[^\]]*\])", out).group(1)))
        costs.append(float(re.search(r"total_cost=([\d.]+)", out).group(1)))
    assert not (set(slices[0]) & set(slices[1])), f"overlapping slices {slices}"
    assert set(slices[0]) | set(slices[1]) == set(range(N_SCENES)), slices
    assert costs[0] == costs[1], f"losses diverged across processes: {costs}"
    print(f"MULTIPROCESS SMOKE PASSED: slices {slices}, loss {costs[0]:.6f} "
          f"identical on both processes")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]))
    else:
        sys.exit(parent())

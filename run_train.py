"""Training entry point (the reference's ``python run.py``, run.py:95-136).

Usage:
  python run_train.py                           # real SUN RGB-D data
  python run_train.py --synthetic=1             # synthetic-scene smoke run
  python run_train.py --data_root=/data/mysunrgbd --cache_dir=cache_train

Defaults replicate the reference recipe: batch 2, Adam 1e-3 -> 1e-4 @80 ->
1e-5 @120, 260 epochs, mAP eval every 5 epochs, train split = indices
5051-10335, val = 1-5050 of the 'training' split (run.py:99,129).
"""

from __future__ import annotations

import argparse
import os

import jax
import numpy as np


def main(argv=None):
    """Train; returns the final TrainState (None with --scan_gt)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", default="/data/mysunrgbd")
    parser.add_argument("--cache_dir", default="cache_train")
    parser.add_argument("--log_dir", default="train_log/run")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic scenes instead of real data")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--pad_semantics", default="reference",
                        choices=["reference", "masked"])
    parser.add_argument("--preset", default="full", choices=["full", "tiny"],
                        help="tiny = scaled-down model for smoke tests; "
                             "full = reference-parity defaults")
    parser.add_argument("--scan_gt", action="store_true",
                        help="scan the split's GT-box count distribution, "
                             "check it against max_gt_boxes, and exit "
                             "(sizes the static cap; the reference pads "
                             "unboundedly, run.py:62-64)")
    parser.add_argument("--with_summaries", action="store_true",
                        help="log per-leaf weight-RMS / grad-norm scalars to "
                             "stat.json (the reference's weight/gradient "
                             "summaries, model.py:236,250)")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="chain K optimizer steps into one jitted "
                             "dispatch (lax.scan over K host-stacked "
                             "batches): same step sequence, K fewer "
                             "host->device dispatches and metric fetches. "
                             "Single-device only; ignored on a mesh")
    parser.add_argument("--seed", type=int, default=0,
                        help="run seed: parameter init + epoch-shuffle order "
                             "(default 0 = the deterministic A2 baseline; "
                             "vary it for independent runs / variance bounds)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process launch: run jax.distributed."
                             "initialize() before anything touches the "
                             "backend, with --coordinator/--num_processes/"
                             "--process_id (argless only where the cluster "
                             "environment describes itself)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args, config_argv = parser.parse_known_args(argv)

    if args.distributed:
        # must run before jax.devices()/apply_config initialize the backend
        if args.coordinator is not None:
            jax.distributed.initialize(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )
        else:
            jax.distributed.initialize()
    is_main = jax.process_index() == 0
    from votenet_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from votenet_tpu.config import config_from_args, default_config
    from votenet_tpu.data.dataflow import SunRGBDDataFlow, batch_scenes
    from votenet_tpu.data.synthetic import synthetic_gt_all, synthetic_scenes
    from votenet_tpu.eval.evaluator import Evaluator, make_packed_predict_fn
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.parallel.mesh import make_mesh
    from votenet_tpu.train.loop import Trainer
    from votenet_tpu.train.state import create_train_state

    from votenet_tpu.config import tiny_config

    cfg = {"tiny": tiny_config, "full": default_config}[args.preset]()
    # any scalar Config field is overridable: --use_pallas=False,
    # --compute_dtype=bfloat16, --max_gt_boxes=128, ...
    cfg = config_from_args(config_argv, base=cfg)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.max_epoch:
        cfg = cfg.replace(max_epoch=args.max_epoch)
    cfg = cfg.replace(data_root=args.data_root, cache_dir=args.cache_dir)

    from votenet_tpu.ops.dispatch import apply_config

    apply_config(cfg)
    n_dev = len(jax.devices())
    mesh = (
        make_mesh(axis_names=cfg.mesh_axis_names, shape=cfg.mesh_shape)
        if n_dev > 1
        else None
    )
    # dp x sp: --mesh_axis_names=data,points --mesh_shape=D,S shards the
    # input cloud over the "points" axis as well (SP backbone); the batch
    # divides only the data axis. On a pod, keep "data" as the OUTER axis
    # so each process's rows land on its own devices (see shard_batch).
    sp = mesh is not None and "points" in mesh.axis_names
    n_mesh = (mesh.shape["data"] if sp else mesh.size) if mesh is not None else 1
    if mesh is not None and cfg.batch_size % n_mesh != 0:
        import warnings

        requested = cfg.batch_size
        cfg = cfg.replace(batch_size=n_mesh * max(1, cfg.batch_size // n_mesh))
        warnings.warn(
            f"batch_size={requested} is not divisible by the {n_mesh}-device "
            f"mesh; training at batch_size={cfg.batch_size} instead",
            stacklevel=1,
        )
    # cfg.batch_size is the GLOBAL batch; on a multi-process pod each
    # process's input pipeline contributes batch_size/process_count rows
    # (assembled into one global array by parallel.mesh.shard_batch)
    pc = jax.process_count()
    if cfg.batch_size % pc != 0:
        raise ValueError(
            f"global batch_size={cfg.batch_size} must be divisible by "
            f"process_count={pc}"
        )
    local_batch = cfg.batch_size // pc
    print(f"devices={n_dev} batch={cfg.batch_size} mesh={mesh} "
          f"proc={jax.process_index()}/{pc} local_rows={local_batch}",
          flush=True)

    if args.synthetic:
        train_scenes = synthetic_scenes(0, cfg, args.synthetic)
        if pc > 1:
            # every process generates the identical global scene list
            # (deterministic), then trains on only its host-local slice
            from votenet_tpu.parallel.mesh import host_local_slice

            train_scenes = [
                train_scenes[i]
                for i in host_local_slice(list(range(len(train_scenes))))
            ]
        val_scenes = synthetic_scenes(1, cfg, max(args.synthetic // 4, 2))
        gt_all = synthetic_gt_all(val_scenes)

        # Seeded epoch shuffling: a fresh permutation per epoch, but the
        # whole sequence is reproducible run-to-run (the A2 determinism
        # guarantee extends to --synthetic runs; the reference seeds its
        # RNGDataFlow per-process the same way).
        shuffle_rng = np.random.default_rng(args.seed)

        def batch_factory():
            from votenet_tpu.data.prefetch import prefetch

            order = shuffle_rng.permutation(len(train_scenes))
            return prefetch(batch_scenes(
                (train_scenes[i] for i in order), local_batch, cfg.max_gt_boxes
            ))

        val_iter = lambda: [(int(s["data_idx"]), s["points"]) for s in val_scenes]
    else:
        from votenet_tpu.parallel.mesh import host_local_slice

        # multi-host pods: each process reads only its slice of the train
        # split (per-host input pipeline over DCN, SURVEY §2.3); identity on
        # a single host
        local_train_idx = host_local_slice(list(range(*cfg.train_idx_range)))
        train_flow = SunRGBDDataFlow(
            cfg.data_root, "training", training=True, config=cfg,
            idx_list=local_train_idx,
            cache_dir=args.cache_dir,
        )
        val_flow = SunRGBDDataFlow(
            cfg.data_root, "training", training=False, config=cfg,
            idx_list=list(range(*cfg.val_idx_range)),
            cache_dir=args.cache_dir + "_val" if args.cache_dir else None,
        )

        def batch_factory():
            from votenet_tpu.data.prefetch import prefetch

            # background-thread prefetch overlaps host scene processing with
            # device steps (the reference's PrefetchDataZMQ+QueueInput role)
            return prefetch(
                batch_scenes(iter(train_flow), local_batch, cfg.max_gt_boxes),
                buffer_size=8,
            )

        from votenet_tpu.eval.evaluator import gt_dict_from_labels

        # periodic eval runs only on process 0 (see eval_callback below);
        # the other hosts skip loading the 5050-scene val split entirely
        if is_main:
            val_cache = [(s["data_idx"], s) for s in val_flow]
            gt_all = gt_dict_from_labels({int(i): s for i, s in val_cache})
            val_iter = lambda: [(int(i), s["points"]) for i, s in val_cache]
        else:
            gt_all, val_iter = {}, lambda: []

    if args.scan_gt:
        import json as _json

        from votenet_tpu.data.dataflow import scan_gt_counts

        stream = iter(train_scenes) if args.synthetic else iter(train_flow)
        report = scan_gt_counts(stream)
        report["max_gt_boxes"] = cfg.max_gt_boxes
        report["fits"] = report["max"] <= cfg.max_gt_boxes
        print(_json.dumps(report))
        if not report["fits"]:
            raise SystemExit(
                f"max GT count {report['max']} exceeds max_gt_boxes="
                f"{cfg.max_gt_boxes}: raise --max_gt_boxes"
            )
        return None

    # LR-schedule epoch boundaries must track what the Trainer counts as an
    # epoch: one exhaustion of the (per-process) train flow. With sliced
    # multi-host input each process sees len(local_train_idx) scenes/epoch.
    # one epoch = one exhaustion of THIS process's flow; every process has
    # the same local scene count (host_local_slice pads by wrapping), so the
    # step counts — and with them the LR schedule and the number of jitted
    # steps entering the SPMD collectives — agree across the pod
    n_epoch_scenes = len(train_scenes) if args.synthetic else len(local_train_idx)
    steps_per_epoch = max(n_epoch_scenes // local_batch, 1)
    state = create_train_state(jax.random.PRNGKey(args.seed), cfg, steps_per_epoch)
    model = (
        VoteNet(cfg, sp_mesh=mesh, sp_batch_axis="data",
                sp_min_points=min(4096, cfg.point_num))
        if sp
        else VoteNet(cfg)
    )
    # eval runs on process 0 as a LOCAL jit — it must not carry the SP
    # model's mesh collectives; params are structure-identical either way
    eval_model = VoteNet(cfg) if sp else model
    # eval batch at least 64: fewer device->host fetch round trips;
    # results are batch-size-independent
    evaluator = Evaluator(cfg, gt_all, batch_size=max(cfg.batch_size, 64))

    # Val points are uploaded to the device ONCE (first eval trigger) and
    # stay resident across all periodic evals (re-uploading 5050 x 20480 x
    # 3 floats is ~1.2 GB per eval at reference scale).
    _val_dev_cache = []

    def eval_callback(state, epoch):
        # mAP eval is process-0-only: the predict fn is an ordinary local
        # jit (no pod collectives), so the other processes simply proceed to
        # the next epoch and block on its first all-reduce until p0 rejoins
        if not is_main:
            return {}
        from votenet_tpu.eval.evaluator import DeviceSceneCache

        if not _val_dev_cache:
            _val_dev_cache.append(
                DeviceSceneCache(val_iter(), batch_size=evaluator.batch_size)
            )
        predict = make_packed_predict_fn(
            eval_model,
            {"params": state.params, "batch_stats": state.batch_stats}, cfg,
        )
        result = evaluator.evaluate(predict, _val_dev_cache[0])
        print(f"[epoch {epoch}] mAP0.25={result['mAP']:.4f}")
        return {"mAP0.25": result["mAP"]}

    trainer = Trainer(
        model, cfg, state,
        log_dir=args.log_dir, mesh=mesh,
        pad_semantics=args.pad_semantics, eval_callback=eval_callback,
        with_summaries=args.with_summaries,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    final_state = trainer.fit(batch_factory)

    # Replicated-state fingerprint: on a pod every process must print the
    # identical value — the gradient all-reduce proof asserted by
    # benchmarks/multiprocess_train_smoke.py.
    import jax.numpy as jnp

    l2 = float(jnp.sqrt(sum(
        jnp.vdot(p, p).real for p in jax.tree_util.tree_leaves(final_state.params)
    )))
    print(f"[proc {jax.process_index()}] final params_l2={l2:.6f}", flush=True)
    return final_state


if __name__ == "__main__":
    main()

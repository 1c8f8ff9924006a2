"""Training harness: jitted train step, epoch loop, callbacks.

Replaces the reference's Tensorpack stack (run.py:95-136): SimpleTrainer ->
jitted/pjit-ed functional train step; ModelSaver -> per-epoch checkpoints
with auto-resume; ScheduledHyperParamSetter -> optax schedule;
SimpleMovingAverage + ScalarPrinter -> MetricLogger; PeriodicTrigger
(Evaluator) -> the eval callback every k epochs.

With a multi-device mesh the same step function runs data-parallel: the
batch is sharded over the "data" axis, the state is replicated, and XLA
inserts the gradient/batch-norm all-reduces between the devices (SURVEY
§2.3).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import jax
import jax.numpy as jnp

from votenet_tpu.config import Config
from votenet_tpu.models.losses import votenet_loss
from votenet_tpu.train.state import TrainState
from votenet_tpu.utils import checkpoint as ckpt
from votenet_tpu.utils.metrics import MetricLogger

GT_KEYS = (
    "bboxes_xyz", "bboxes_lwh", "bboxes_roty", "semantic_labels",
    "heading_labels", "heading_residuals", "size_labels", "size_residuals",
    "gt_count",
)


def param_summary_scalars(params, grads) -> Dict[str, jnp.ndarray]:
    """Per-leaf weight RMS and gradient L2-norm scalars.

    The reference emits per-weight histogram/RMS summaries
    (``tf.summary.histogram`` + ``add_moving_summary(rms(v))``,
    /root/reference/model.py:236) and per-gradient summaries
    (``gradproc.SummaryGradient``, model.py:250). The equivalent here is a
    flat dict of ``w_rms/<path>`` and ``g_norm/<path>`` scalars computed
    in-graph (a handful of tiny reductions — negligible next to the model),
    plus a ``g_norm/global`` total. Keys use '/'-joined module paths, e.g.
    ``w_rms/backbone/sa1/mlp/dense0/kernel``.
    """
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        name = "/".join(
            getattr(p, "key", getattr(p, "name", str(p))) for p in path
        )
        out[f"w_rms/{name}"] = jnp.sqrt(jnp.mean(jnp.square(leaf)))
    sq_sum = jnp.zeros((), jnp.float32)
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        name = "/".join(
            getattr(p, "key", getattr(p, "name", str(p))) for p in path
        )
        leaf_sq = jnp.sum(jnp.square(leaf.astype(jnp.float32)))
        out[f"g_norm/{name}"] = jnp.sqrt(leaf_sq)
        sq_sum = sq_sum + leaf_sq
    out["g_norm/global"] = jnp.sqrt(sq_sum)
    return out


def make_train_step(
    model, config: Config, pad_semantics: str = "reference",
    with_summaries: bool = False,
):
    """Build the pure (state, batch) -> (state, metrics) step function.

    ``with_summaries`` adds per-leaf weight-RMS / grad-norm scalars to the
    metrics dict (see :func:`param_summary_scalars`) — parity with the
    reference's weight/gradient summaries (model.py:236,250).
    """

    def train_step(state: TrainState, batch: Dict):
        gt = {k: batch[k] for k in GT_KEYS}

        def loss_fn(params):
            end_points, mutated = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                batch["points"],
                train=True,
                mutable=["batch_stats"],
            )
            losses = votenet_loss(end_points, gt, config, pad_semantics)
            return losses.total, (losses, mutated["batch_stats"])

        (_, (losses, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        metrics = {
            "total_cost": losses.total,
            "vote_reg_loss": losses.vote_reg_loss,
            "obj_cls_loss": losses.obj_cls_loss,
            "box_loss": losses.box_loss,
            "sem_cls_loss": losses.sem_cls_loss,
            "obj_accuracy": losses.obj_accuracy,
            "sem_accuracy": losses.sem_accuracy,
        }
        if with_summaries:
            metrics.update(param_summary_scalars(state.params, grads))
        state = state.apply_gradients(grads=grads, batch_stats=new_bs)
        return state, metrics

    return train_step


class Trainer:
    """Epoch-driven training with checkpointing, logging and eval callbacks."""

    def __init__(
        self,
        model,
        config: Config,
        state: TrainState,
        log_dir: Optional[str] = None,
        mesh=None,
        pad_semantics: str = "reference",
        eval_callback: Optional[Callable[[TrainState, int], Dict]] = None,
        with_summaries: bool = False,
        steps_per_dispatch: int = 1,
    ):
        self.model = model
        self.config = config
        self.state = state
        self.log_dir = log_dir
        self.mesh = mesh
        self.eval_callback = eval_callback
        # steps_per_dispatch > 1 chains K optimizer steps into ONE jitted
        # call (lax.scan over K host-stacked batches): the same step
        # sequence, K fewer host->device dispatches, and one metric fetch
        # per chunk. Single-device only (a pod's per-host input pipelines
        # feed per-step shard_batch placement; K=1 there).
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        if mesh is not None:
            self.steps_per_dispatch = 1
        self._train_chunk = None  # built lazily (size-specialized)
        # Multi-process pods: every process runs the identical jitted steps
        # (SPMD), but only process 0 writes checkpoints/stat.json and prints
        # step lines. log_dir does NOT need to be shared: resume() restores
        # on process 0 and broadcasts the state to every other process.
        self.is_main = jax.process_index() == 0
        self.logger = MetricLogger(
            log_dir if self.is_main else None, quiet=not self.is_main
        )
        self.epoch = 0

        step_fn = make_train_step(
            model, config, pad_semantics, with_summaries=with_summaries
        )
        self._step_fn = step_fn
        # dp x sp: a mesh with a "points" axis shards the input cloud over
        # its point dimension as well (the SP backbone must be enabled on
        # the model via VoteNet(sp_mesh=...) by the caller — run_train does)
        self._point_axis = (
            "points" if mesh is not None and "points" in mesh.axis_names else None
        )
        if mesh is not None:
            from votenet_tpu.parallel.mesh import replicated_sharding

            repl = replicated_sharding(mesh)
            # batch shardings are per-key (the "points" key differs under
            # dp x sp); the placed arrays carry them, so jit infers the
            # batch argument's shardings from its committed inputs
            self._train_step = jax.jit(
                step_fn,
                in_shardings=(repl, None),
                out_shardings=(repl, repl),
                donate_argnums=0,
            )
        else:
            self._train_step = jax.jit(step_fn, donate_argnums=0)

    def resume(self) -> Optional[int]:
        """Auto-resume from the latest checkpoint (AutoResumeTrainConfig).

        Multi-process pods need no shared filesystem: only process 0 reads
        its checkpoint directory; the restored state (and the found/step
        scalars) are broadcast to every process over the mesh. Hosts whose
        local log_dir is stale or absent still resume consistently.
        """
        if not self.log_dir:
            return None
        if jax.process_count() > 1:
            return self._resume_broadcast()
        state, step = ckpt.restore_checkpoint(self.log_dir, self.state)
        if step is not None:
            self.state = state
            self.epoch = int(step)
            if self.is_main:
                print(f"resumed from epoch {self.epoch}", flush=True)
        return step

    def _resume_broadcast(self) -> Optional[int]:
        from jax.experimental import multihost_utils

        if self.is_main:
            state, step = ckpt.restore_checkpoint(self.log_dir, self.state)
            found = step is not None
            if not found:
                state = self.state
        else:
            state, step, found = self.state, 0, False
        flag_step = multihost_utils.broadcast_one_to_all(
            jnp.asarray([1 if found else 0, int(step or 0)], jnp.int32)
        )
        if int(flag_step[0]) == 0:
            return None
        # non-zero processes contribute zeros; process 0's restored leaves win
        self.state = multihost_utils.broadcast_one_to_all(state)
        self.epoch = int(flag_step[1])
        # every process prints (one line per pod member — the proof each
        # host really took the broadcast, not a stale local checkpoint)
        print(
            f"[proc {jax.process_index()}] resumed from epoch {self.epoch} "
            f"(broadcast)", flush=True,
        )
        return self.epoch

    def _put_batch(self, batch: Dict) -> Dict:
        if self.mesh is not None:
            from votenet_tpu.parallel.mesh import shard_batch

            return shard_batch(batch, self.mesh, point_axis=self._point_axis)
        return batch

    def train_epoch(self, batches: Iterable[Dict], metrics_every: int = 10) -> Dict[str, float]:
        """One epoch. Metrics are fetched to the host only every
        ``metrics_every`` steps — each fetch synchronizes the device, while
        steps in between stay async-dispatched back-to-back. With ``steps_per_dispatch`` K > 1
        the epoch runs in K-step jitted chunks (same step sequence, K
        fewer dispatches; see __init__)."""
        if self.steps_per_dispatch > 1:
            return self._train_epoch_chunked(batches, metrics_every)
        step_in_epoch = 0
        metrics = None
        for batch in batches:
            self.state, metrics = self._train_step(self.state, self._put_batch(batch))
            step_in_epoch += 1
            if step_in_epoch % metrics_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                self.logger.log_step(int(self.state.step), host)
        if metrics is not None and step_in_epoch % metrics_every != 0:
            host = {k: float(v) for k, v in metrics.items()}
            self.logger.log_step(int(self.state.step), host)
        self.epoch += 1
        return self.logger.moving.averages()

    def _train_epoch_chunked(self, batches: Iterable[Dict], metrics_every: int) -> Dict[str, float]:
        """K-steps-per-dispatch epoch: host-stack K batches, one jitted
        lax.scan of the SAME step function over them. A short tail (epoch
        length not divisible by K) runs through the single-step path, so
        any epoch length trains the identical step sequence."""
        import numpy as np

        K = self.steps_per_dispatch
        if self._train_chunk is None:
            step_fn = self._step_fn

            def chunk_fn(state, stacked):
                def body(s, b):
                    return step_fn(s, b)

                state, ms = jax.lax.scan(body, state, stacked)
                # only the chunk's final metrics leave the device
                return state, jax.tree_util.tree_map(lambda a: a[-1], ms)

            self._train_chunk = jax.jit(chunk_fn, donate_argnums=0)

        log_every_chunks = max(1, metrics_every // K)
        metrics = None
        chunk_i = 0
        # Deferred metric logging: float()-ing a chunk's metrics right after
        # dispatch would SYNC on that chunk (which serializes
        # transfer/compute pipelining). Instead the fetch happens
        # one chunk LATER — by then the values are ready and the fetch is
        # free. Step numbers are tracked on the host for the same reason
        # (int(state.step) would also sync).
        pending_log = None  # (host_step, device metrics)
        host_step = int(self.state.step)  # state is materialized here: free
        it = iter(batches)
        while True:
            chunk = []
            for batch in it:
                chunk.append(batch)
                if len(chunk) == K:
                    break
            if not chunk:
                break
            if len(chunk) < K:  # tail: single-step path
                for batch in chunk:
                    self.state, metrics = self._train_step(
                        self.state, self._put_batch(batch)
                    )
                    host_step += 1
                pending_log = (host_step, metrics)
                break
            stacked = {
                k: np.stack([np.asarray(b[k]) for b in chunk])
                for k in chunk[0]
            }
            self.state, metrics = self._train_chunk(self.state, stacked)
            chunk_i += 1
            host_step += K
            if pending_log is not None:
                step_no, m = pending_log
                self.logger.log_step(
                    step_no, {k: float(v) for k, v in m.items()}
                )
                pending_log = None
            if chunk_i % log_every_chunks == 0:
                pending_log = (host_step, metrics)
        if pending_log is not None:
            step_no, m = pending_log
            self.logger.log_step(step_no, {k: float(v) for k, v in m.items()})
        elif metrics is not None:
            self.logger.log_step(
                host_step, {k: float(v) for k, v in metrics.items()}
            )
        self.epoch += 1
        return self.logger.moving.averages()

    def fit(
        self,
        batch_factory: Callable[[], Iterable[Dict]],
        max_epoch: Optional[int] = None,
    ):
        """Full training run with per-epoch checkpoints and periodic eval."""
        max_epoch = max_epoch or self.config.max_epoch
        self.resume()
        while self.epoch < max_epoch:
            t0 = time.time()
            self.train_epoch(batch_factory())
            epoch_scalars = {"epoch_time": time.time() - t0}
            if (
                self.eval_callback is not None
                and self.epoch % self.config.eval_every_k_epochs == 0
            ):
                eval_metrics = self.eval_callback(self.state, self.epoch)
                epoch_scalars.update(
                    {k: v for k, v in eval_metrics.items() if isinstance(v, (int, float))}
                )
            self.logger.log_epoch(self.epoch, epoch_scalars)
            if self.log_dir and self.is_main:
                ckpt.save_checkpoint(self.log_dir, self.state, self.epoch)
        return self.state

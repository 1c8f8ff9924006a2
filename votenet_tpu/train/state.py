"""Train state: params + batch_stats + optimizer state, one pytree.

Replaces the reference's TF graph variables + Tensorpack session state with
an explicit functional state that jit/pjit can thread, donate, shard and
checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import optax

from votenet_tpu.config import Config


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Step counter, model variables and optimizer state.

    ``apply_fn`` and ``tx`` are static (not pytree leaves); everything else
    is carried through jit, donation and checkpoints.
    """

    step: Any
    params: Any
    batch_stats: Any
    opt_state: Any
    apply_fn: Callable = dataclasses.field(metadata=dict(static=True))
    tx: optax.GradientTransformation = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def create(cls, *, apply_fn, params, batch_stats, tx) -> "TrainState":
        return cls(
            step=0, params=params, batch_stats=batch_stats,
            opt_state=tx.init(params), apply_fn=apply_fn, tx=tx,
        )

    def replace(self, **updates) -> "TrainState":
        return dataclasses.replace(self, **updates)

    def apply_gradients(self, *, grads, **updates) -> "TrainState":
        """One optimizer update; ``updates`` replace other fields (e.g. the
        new ``batch_stats`` of the same step)."""
        deltas, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, deltas),
            opt_state=opt_state,
            **updates,
        )


def create_train_state(
    rng: jax.Array, config: Config, steps_per_epoch: int
) -> TrainState:
    """Initialize model variables and the optimizer."""
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.train.optimizer import make_optimizer

    import jax.numpy as jnp

    model = VoteNet(config)
    dummy = jnp.zeros((1, config.point_num, 3), jnp.float32)
    variables = model.init(rng, dummy, train=False)
    tx = make_optimizer(config, steps_per_epoch)
    return TrainState.create(
        apply_fn=model.apply,
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=tx,
    )

"""Checkpoint save/restore with auto-resume.

Replaces the reference's Tensorpack ``ModelSaver`` (every epoch,
run.py:125) + ``AutoResumeTrainConfig`` (run.py:116-117: restart from the
latest checkpoint in the log dir if one exists). Format: one ``np.savez``
archive per step holding every array leaf of the state pytree under its
key path (``jax.tree_util.keystr``, e.g. ``.params['sa1']['mlp']...``);
restore reads the leaves back into the structure of a template state. The
latest ``keep`` checkpoints are retained; each is published atomically.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import jax
import numpy as np


def checkpoint_path(log_dir: str, step: int) -> str:
    return os.path.join(log_dir, f"checkpoint_{step:010d}.npz")


def save_checkpoint(log_dir: str, state: Any, step: int, keep: int = 3) -> str:
    """Serialize ``state`` at ``step``; prune old checkpoints."""
    os.makedirs(log_dir, exist_ok=True)
    path = checkpoint_path(log_dir, step)
    leaves = jax.tree_util.tree_leaves_with_path(state)
    arrays = {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic publish
    existing = sorted(all_checkpoint_steps(log_dir))
    for old in existing[:-keep]:
        os.remove(checkpoint_path(log_dir, old))
    return path


def all_checkpoint_steps(log_dir: str):
    if not os.path.isdir(log_dir):
        return []
    steps = []
    for name in os.listdir(log_dir):
        m = re.fullmatch(r"checkpoint_(\d+)\.npz", name)
        if m:
            steps.append(int(m.group(1)))
    return steps


def latest_checkpoint_step(log_dir: str) -> Optional[int]:
    steps = all_checkpoint_steps(log_dir)
    return max(steps) if steps else None


def restore_checkpoint(log_dir: str, target: Any, step: Optional[int] = None):
    """Restore into the structure of ``target``; returns (state, step) or
    (target, None) when there is nothing to resume from. Every leaf of
    ``target`` must be in the archive, with its shape."""
    if step is None:
        step = latest_checkpoint_step(log_dir)
    if step is None:
        return target, None
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    with np.load(checkpoint_path(log_dir, step)) as archive:
        restored = []
        for path, old in leaves:
            key = jax.tree_util.keystr(path)
            if key not in archive:
                raise KeyError(f"checkpoint step {step} has no leaf {key}")
            new = archive[key]
            if new.dtype.kind == "V":  # bfloat16 & co. are stored as raw bytes
                new = new.view(old.dtype)
            if new.shape != np.shape(old):
                raise ValueError(
                    f"leaf {key}: checkpoint shape {new.shape} != {np.shape(old)}"
                )
            if isinstance(old, jax.Array):
                new = jax.numpy.asarray(new)
            elif isinstance(old, (int, float)):
                new = type(old)(new)  # a Python scalar leaf, e.g. step 0
            restored.append(new)
    return jax.tree_util.tree_unflatten(treedef, restored), step

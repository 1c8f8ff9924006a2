"""A small functional layer library: modules, Dense, BatchNorm, remat.

The model needs a handful of layers and a variable tree
``{"params": ..., "batch_stats": ...}`` that jit, grad and sharding can
thread. This module provides exactly that with nothing but JAX:

- :class:`Module` — a dataclass whose ``__call__`` runs inside a *scope*, a
  path of submodule names into the variable tree. ``Model(...).init(rng,
  *args)`` builds the variables; ``Model(...).apply(variables, *args,
  mutable=[...])`` runs the pure forward and returns the updated mutable
  collections alongside the output. Submodules are created and called
  inside ``__call__`` and must be given a ``name``.
- :class:`Dense` (He-normal kernel, the tensorpack default), :class:`BatchNorm`
  (tensorpack momentum 0.9 / eps 1e-5 by default here, train and eval
  modes, running statistics in ``batch_stats``), :func:`relu`.
- :func:`remat` — recompute a module's activations in the backward pass
  (``jax.checkpoint`` around the module call).

Each parameter's initial value is drawn from the init key folded with a
SHA-1 hash of its module path and its creation index within that module
(the scheme of flax.linen, which this library replaced, so a seed gives the
same initial weights as before).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

# tensorpack's Conv2D/FullyConnected default: variance_scaling(2.0), i.e. He
he_normal = jax.nn.initializers.he_normal()
relu = jax.nn.relu

_local = threading.local()


class _Root:
    """The variable collections of one init/apply call."""

    def __init__(self, variables, mutable, rng, initializing):
        self.variables = variables  # {collection: nested dict}
        self.mutable = mutable      # set of writable collection names
        self.rng = rng
        self.initializing = initializing
        self.counters = collections.Counter()  # params created per path


def _param_key(rng, path: Tuple[str, ...], index: int):
    """fold_in(rng, first 4 bytes of SHA-1(path names, index))."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(index.to_bytes((index.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(rng, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class Scope:
    """A position (path of module names) in a :class:`_Root`'s tree."""

    def __init__(self, root: _Root, path: Tuple[str, ...] = ()):
        self.root = root
        self.path = path

    def child(self, name: str) -> "Scope":
        return Scope(self.root, self.path + (name,))

    def _node(self, col: str, create: bool) -> Optional[Dict]:
        node = self.root.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.root.variables[col] = {}
        for name in self.path:
            if name not in node:
                if not create:
                    return None
                node[name] = {}
            node = node[name]
        return node

    def _where(self, name: str) -> str:
        return "/".join(self.path + (name,))

    def param(self, name: str, init_fn: Callable, *init_args):
        node = self._node("params", create=self.root.initializing)
        if node is None or name not in node:
            if not self.root.initializing:
                raise KeyError(f"missing parameter {self._where(name)}")
            self.root.counters[self.path] += 1
            key = _param_key(self.root.rng, self.path, self.root.counters[self.path])
            node[name] = init_fn(key, *init_args)
        return node[name]

    def get(self, col: str, name: str, init_fn: Callable):
        node = self._node(col, create=self.root.initializing)
        if node is None or name not in node:
            if not self.root.initializing:
                raise KeyError(f"missing variable {col}:{self._where(name)}")
            node[name] = init_fn()
        return node[name]

    def put(self, col: str, name: str, value) -> None:
        if col not in self.root.mutable:
            raise ValueError(
                f"collection {col!r} is immutable here; pass mutable=[{col!r}]"
            )
        self._node(col, create=True)[name] = value


def _current() -> Scope:
    stack = getattr(_local, "stack", None)
    if not stack:
        raise RuntimeError("modules run only inside Module.init / Module.apply")
    return stack[-1]


def _run_in(scope: Scope, fn, *args, **kwargs):
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(scope)
    try:
        return fn(*args, **kwargs)
    finally:
        stack.pop()


def _copy_tree(tree):
    """Copy the dict structure (not the arrays) of a variable tree."""
    return {k: _copy_tree(v) if isinstance(v, dict) else v for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class Module:
    """Base of every layer: a frozen (hashable) dataclass of hyperparameters
    plus a name."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)
    _remat_static: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, kw_only=True, repr=False, compare=False
    )

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        call = cls.__dict__.get("__call__")
        if call is not None:
            cls._raw_call = call
            cls.__call__ = _scoped_call(call)

    # -- variables of the module being called --
    def param(self, name: str, init_fn: Callable, *init_args):
        return _current().param(name, init_fn, *init_args)

    def variable_get(self, col: str, name: str, init_fn: Callable):
        return _current().get(col, name, init_fn)

    def variable_put(self, col: str, name: str, value) -> None:
        _current().put(col, name, value)

    def is_initializing(self) -> bool:
        return _current().root.initializing

    # -- entry points --
    def init(self, rng, *args, **kwargs) -> Dict[str, Any]:
        """Build the variable collections by running the forward once."""
        root = _Root({}, {"params", "batch_stats"}, rng, initializing=True)
        _run_in(Scope(root), type(self)._raw_call, self, *args, **kwargs)
        return root.variables

    def apply(self, variables: Dict[str, Any], *args, mutable=False, **kwargs):
        """Pure forward. ``mutable`` names the collections the call may
        update (e.g. ``["batch_stats"]`` in training); they are returned
        as ``(output, {collection: tree})``. ``mutable=False`` returns the
        output alone."""
        if mutable is True:
            mutable = list(variables)
        elif isinstance(mutable, str):
            mutable = [mutable]
        mutable = list(mutable or [])
        tree = {
            col: _copy_tree(v) if col in mutable else v
            for col, v in variables.items()
        }
        root = _Root(tree, set(mutable), None, initializing=False)
        out = _run_in(Scope(root), type(self)._raw_call, self, *args, **kwargs)
        if not mutable:
            return out
        return out, {col: root.variables.get(col, {}) for col in mutable}


def _scoped_call(call):
    @functools.wraps(call)
    def wrapped(self, *args, **kwargs):
        if self.name is None:
            raise ValueError(f"{type(self).__name__} submodule needs a name")
        scope = _current().child(self.name)
        if self._remat_static is None or scope.root.initializing:
            return _run_in(scope, call, self, *args, **kwargs)
        return _remat_call(self, call, scope, args, kwargs)

    return wrapped


def _remat_call(module, call, scope: Scope, args, kwargs):
    """Run ``call`` under jax.checkpoint as a pure function of the module's
    variable subtree, then write its mutable updates back."""
    root = scope.root
    cols = list(root.variables)
    sub = {col: scope._node(col, create=False) or {} for col in cols}
    static = tuple(i + 1 for i in module._remat_static)  # +1: the subtree

    def pure(sub_vars, *a, **kw):
        inner = _Root(_copy_tree(sub_vars), root.mutable, None, initializing=False)
        out = _run_in(Scope(inner), call, module, *a, **kw)
        return out, {c: inner.variables[c] for c in cols if c in root.mutable}

    out, updates = jax.checkpoint(pure, static_argnums=static)(sub, *args, **kwargs)
    for col, tree in updates.items():
        node = scope._node(col, create=True)
        node.clear()
        node.update(tree)
    return out


def remat(cls, static_argnums: Sequence[int] = ()):
    """A variant of module class ``cls`` whose call is rematerialised in the
    backward pass. ``static_argnums`` index the call's positional arguments
    (self excluded) that are Python values, e.g. a ``train`` flag."""

    @functools.wraps(cls, updated=())
    def make(*args, **kwargs):
        return cls(*args, _remat_static=tuple(static_argnums), **kwargs)

    return make


class Dense(Module):
    """``x @ kernel + bias`` over the last axis; He-normal kernel."""

    features: int
    dtype: Any = jnp.float32

    def __call__(self, x):
        kernel = self.param(
            "kernel", he_normal, (x.shape[-1], self.features), jnp.float32
        )
        bias = self.param("bias", jax.nn.initializers.zeros, (self.features,), jnp.float32)
        x, kernel, bias = (a.astype(self.dtype) for a in (x, kernel, bias))
        return lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ()))) + bias


class BatchNorm(Module):
    """Batch normalisation over every axis but the last.

    Training (``use_running_average=False``) normalises with the batch's
    mean and (E[x^2] - E[x]^2) variance, computed in f32, and — outside
    init — folds them into the running statistics
    ``new = momentum * old + (1 - momentum) * batch``. Evaluation uses the
    running statistics.
    """

    use_running_average: bool
    momentum: float = 0.9
    epsilon: float = 1e-5
    dtype: Any = jnp.float32

    def __call__(self, x):
        feat = x.shape[-1]
        ra_mean = self.variable_get(
            "batch_stats", "mean", lambda: jnp.zeros((feat,), jnp.float32)
        )
        ra_var = self.variable_get(
            "batch_stats", "var", lambda: jnp.ones((feat,), jnp.float32)
        )
        scale = self.param("scale", jax.nn.initializers.ones, (feat,), jnp.float32)
        bias = self.param("bias", jax.nn.initializers.zeros, (feat,), jnp.float32)
        if self.use_running_average:
            mean, var = ra_mean, ra_var
        else:
            xf = x.astype(jnp.float32)
            axes = tuple(range(x.ndim - 1))
            mean = jnp.mean(xf, axes)
            var = jnp.maximum(0.0, jnp.mean(xf * xf, axes) - mean * mean)
            if not self.is_initializing():
                m = self.momentum
                self.variable_put("batch_stats", "mean", m * ra_mean + (1 - m) * mean)
                self.variable_put("batch_stats", "var", m * ra_var + (1 - m) * var)
        y = (x - mean) * (lax.rsqrt(var + self.epsilon) * scale) + bias
        return y.astype(self.dtype)

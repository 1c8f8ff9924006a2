"""One rule for JAX's persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives at one fixed path inside the
checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): the path is
part of what makes a later process find the entries again, so it never
depends on a temp name, a PID or the time.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory the rule picks for this environment."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or DEFAULT_DIR


def setup_compile_cache() -> str:
    """Apply the rule (call before the first compilation); returns the path."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path

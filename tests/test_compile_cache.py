"""The one compile-cache rule and chip_smoke.py's refusal to run without
a GPU."""

import os
import shutil
import subprocess
import sys

from votenet_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCacheRule:
    def test_env_var_wins(self):
        assert cc.compile_cache_dir({cc.ENV_VAR: "/some/where"}) == "/some/where"

    def test_default_is_fixed_path_in_checkout(self):
        path = cc.compile_cache_dir({})
        assert path == os.path.join(REPO, ".jax_cache")
        assert path == cc.compile_cache_dir({cc.ENV_VAR: ""})
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert "/.jax_cache/" in f.read().split()

    def test_setup_sets_jax_config_only_without_env(self, monkeypatch):
        import jax

        seen = []
        monkeypatch.setattr(jax.config, "update", lambda k, v: seen.append((k, v)))
        monkeypatch.setenv(cc.ENV_VAR, "/from/env")
        assert cc.setup_compile_cache() == "/from/env"
        assert seen == []
        monkeypatch.delenv(cc.ENV_VAR)
        assert cc.setup_compile_cache() == cc.DEFAULT_DIR
        assert seen == [("jax_compilation_cache_dir", cc.DEFAULT_DIR)]


class TestChipSmokeWithoutGPU:
    def _run(self, cwd):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )

    def test_cpu_exits_nonzero_without_result(self):
        res = self._run(REPO)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout

    def test_alone_exits_nonzero(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        res = self._run(str(tmp_path))
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout

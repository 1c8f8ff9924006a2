"""Tests for the GPU-kernel/XLA dispatch gate (ops/dispatch.py).

Config.use_pallas must actually control dispatch. We fake a GPU backend by
monkeypatching ``gpu_available`` and replace the kernels with recorders
(the compiled kernels cannot run on this CPU backend), then check which
implementation each op reaches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import votenet_tpu.ops.pallas as ops_pallas
from votenet_tpu.ops import dispatch
from votenet_tpu.ops.sampling import farthest_point_sample, farthest_point_sample_xla


@pytest.fixture
def fake_gpu(monkeypatch):
    """Pretend the default backend is a GPU; the kernels record their calls
    and answer with the XLA twins."""
    from votenet_tpu.ops.grouping import query_ball_point_dense
    from votenet_tpu.ops.pallas import ballquery, fps

    calls = []
    monkeypatch.setattr(ops_pallas, "gpu_available", lambda: True)
    monkeypatch.setattr(
        fps, "farthest_point_sample_gpu",
        lambda m, x: calls.append("fps") or farthest_point_sample_xla(m, x),
    )
    monkeypatch.setattr(
        ballquery, "query_ball_point_gpu",
        lambda r, k, a, b: calls.append("bq") or query_ball_point_dense(r, k, a, b),
    )
    dispatch.set_use_pallas(True)
    yield calls
    dispatch.set_use_pallas(True)


class TestDispatchGate:
    def test_cpu_backend_never_uses_pallas(self):
        dispatch.set_use_pallas(True)
        assert dispatch.use_gpu_kernels() is False  # tests run on CPU

    def test_gpu_available_reads_default_backend(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert ops_pallas.gpu_available() is True
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        assert ops_pallas.gpu_available() is False

    def test_set_use_pallas_gates_fake_gpu(self, fake_gpu):
        assert dispatch.use_gpu_kernels() is True
        dispatch.set_use_pallas(False)
        assert dispatch.use_gpu_kernels() is False

    def test_pallas_disabled_context(self, fake_gpu):
        with dispatch.pallas_disabled():
            assert dispatch.use_gpu_kernels() is False
        assert dispatch.use_gpu_kernels() is True

    def test_fake_gpu_routes_fps_to_kernel(self, fake_gpu, rng):
        xyz = jnp.asarray(rng.randn(2, 64, 3).astype(np.float32))
        got = farthest_point_sample(8, xyz)
        assert fake_gpu == ["fps"]
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(farthest_point_sample_xla(8, xyz))
        )

    def test_fake_gpu_routes_ball_query_to_kernel(self, fake_gpu, rng):
        from votenet_tpu.ops.grouping import query_ball_point

        xyz = jnp.asarray(rng.randn(2, 64, 3).astype(np.float32))
        query_ball_point(0.5, 8, xyz, xyz[:, :16])
        assert fake_gpu == ["bq"]

    def test_disabled_dispatch_runs_xla_twin(self, fake_gpu, rng):
        """On a (faked) GPU with use_pallas=False, both ops take the XLA
        path: no kernel call is recorded."""
        from votenet_tpu.ops.grouping import query_ball_point

        dispatch.set_use_pallas(False)
        xyz = jnp.asarray(rng.randn(2, 64, 3).astype(np.float32))
        farthest_point_sample(8, xyz)
        query_ball_point(0.5, 8, xyz, xyz[:, :16])
        assert fake_gpu == []

    def test_fast_bf16_ball_query_stays_on_twin(self, fake_gpu, rng):
        from votenet_tpu.ops.grouping import query_ball_point

        dispatch.set_bq_precision("fast_bf16")
        try:
            xyz = jnp.asarray(rng.randn(1, 64, 3).astype(np.float32))
            query_ball_point(0.5, 8, xyz, xyz[:, :8])
        finally:
            dispatch.set_bq_precision("exact")
        assert fake_gpu == []

    def test_cpu_routes_to_twins(self, monkeypatch, rng):
        from votenet_tpu.ops.grouping import query_ball_point
        from votenet_tpu.ops.pallas import ballquery, fps

        def boom(*a, **k):
            raise AssertionError("kernel reached on the CPU")

        monkeypatch.setattr(fps, "farthest_point_sample_gpu", boom)
        monkeypatch.setattr(ballquery, "query_ball_point_gpu", boom)
        xyz = jnp.asarray(rng.randn(1, 64, 3).astype(np.float32))
        farthest_point_sample(8, xyz)
        query_ball_point(0.5, 8, xyz, xyz[:, :8])

    def test_model_forward_reaches_both_kernels(self, fake_gpu, rng):
        """Every SA layer and the proposal layer go through the kernels."""
        from votenet_tpu.config import tiny_config
        from votenet_tpu.models.votenet import VoteNet

        cfg = tiny_config()
        pts = jnp.asarray(rng.uniform(-3, 3, (1, cfg.point_num, 3)), jnp.float32)
        VoteNet(cfg).init(jax.random.PRNGKey(0), pts, train=False)
        assert fake_gpu.count("fps") == 5 and fake_gpu.count("bq") == 5

    def test_config_knob_reaches_dispatch(self):
        from votenet_tpu.config import config_from_args

        cfg = config_from_args(["--use_pallas=False"])
        assert cfg.use_pallas is False
        cfg = config_from_args(["--use_pallas=True"])
        assert cfg.use_pallas is True

    def test_gather_packing_cli_wiring(self):
        """--gather_packing=bf16_hilo must flow CLI -> Config ->
        apply_config -> dispatch (the DESIGN.md opt-in contract)."""
        from votenet_tpu.config import config_from_args

        cfg = config_from_args(["--gather_packing=bf16_hilo"])
        assert cfg.gather_packing == "bf16_hilo"
        prev = dispatch.gather_packing()
        try:
            dispatch.apply_config(cfg)
            assert dispatch.gather_packing() == "bf16_hilo"
            with pytest.raises(ValueError):
                dispatch.set_gather_packing("bf16")  # typo'd mode
        finally:
            dispatch.set_gather_packing(prev)
            dispatch.apply_config(config_from_args([]))

    def test_predictor_applies_config(self, monkeypatch):
        import votenet_tpu.predictor as predictor_mod

        seen = []
        monkeypatch.setattr(
            "votenet_tpu.ops.dispatch.set_use_pallas", lambda v: seen.append(v)
        )
        from votenet_tpu.config import tiny_config

        try:
            predictor_mod.VoteNetPredictor(
                config=tiny_config(use_pallas=False), batch_size=1
            )
        except Exception:
            pass  # param init may be heavy; the gate call happens first
        assert seen and seen[0] is False


class TestBqPrecisionGate:
    def test_default_is_exact(self):
        assert dispatch.bq_precision() == "exact"

    def test_set_and_validate(self):
        import pytest

        dispatch.set_bq_precision("fast_bf16")
        try:
            assert dispatch.bq_precision() == "fast_bf16"
        finally:
            dispatch.set_bq_precision("exact")
        with pytest.raises(ValueError, match="bq_precision"):
            dispatch.set_bq_precision("wat")

    def test_apply_config_wires_it(self):
        from votenet_tpu.config import default_config

        dispatch.apply_config(default_config(bq_precision="fast_bf16"))
        try:
            assert dispatch.bq_precision() == "fast_bf16"
        finally:
            dispatch.apply_config(default_config())
            assert dispatch.bq_precision() == "exact"

    def test_mode_flip_is_not_masked_by_jit_cache(self, rng):
        """The mode is read OUTSIDE the op's jit (a fresh static arg per
        mode), so flipping it after a first call must take effect. On CPU
        both modes agree on these points, so we assert equality both ways —
        the point is that each call traces with its current mode."""
        from votenet_tpu.ops.grouping import (
            _query_ball_point_dense,
            query_ball_point_dense,
        )

        xyz1 = jnp.asarray(rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
        xyz2 = xyz1[:, :8]
        i1, c1 = query_ball_point_dense(0.5, 8, xyz1, xyz2)
        dispatch.set_bq_precision("fast_bf16")
        try:
            i2, c2 = query_ball_point_dense(0.5, 8, xyz1, xyz2)
        finally:
            dispatch.set_bq_precision("exact")
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        # each mode is its own jit specialization
        assert _query_ball_point_dense._cache_size() >= 2


class TestStrictConfigArgs:
    def test_misspelled_override_errors(self):
        """A typo'd --flag must error, not be silently dropped."""
        import pytest as _pytest

        from votenet_tpu.config import config_from_args

        with _pytest.raises(SystemExit):
            config_from_args(["--use_palas=False"])  # sic

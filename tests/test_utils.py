"""Tests for metrics/logging and config utilities."""

import json
import os

import numpy as np
import pytest

from votenet_tpu.config import Config, config_from_args, default_config
from votenet_tpu.utils.metrics import MetricLogger, MovingAverage


class TestMovingAverage:
    def test_window(self):
        ma = MovingAverage(window=3)
        for v in [1, 2, 3, 4]:
            ma.update({"x": v})
        assert ma.averages()["x"] == pytest.approx(3.0)  # mean of 2,3,4

    def test_multiple_keys(self):
        ma = MovingAverage(window=10)
        ma.update({"a": 1.0, "b": 2.0})
        ma.update({"a": 3.0})
        avg = ma.averages()
        assert avg["a"] == pytest.approx(2.0)
        assert avg["b"] == pytest.approx(2.0)


class TestMetricLogger:
    def test_stat_json_written(self, tmp_path):
        log_dir = str(tmp_path / "log")
        logger = MetricLogger(log_dir, print_every=1000)
        logger.log_step(1, {"total_cost": 2.0})
        logger.log_epoch(1, {"mAP0.25": 0.5})
        with open(os.path.join(log_dir, "stat.json")) as f:
            hist = json.load(f)
        assert hist[0]["epoch_num"] == 1
        assert hist[0]["mAP0.25"] == 0.5
        assert hist[0]["total_cost"] == 2.0


class TestConfig:
    def test_defaults_match_reference(self):
        cfg = default_config()
        assert cfg.point_num == 20480
        assert cfg.num_heading_bin == 12
        assert cfg.proposal_num == 256
        assert cfg.num_proposal_channels == 79
        assert cfg.batch_size == 2
        assert cfg.lr_schedule == ((80, 1e-4), (120, 1e-5))

    def test_cli_overrides(self):
        cfg = config_from_args(["--batch_size=16", "--base_lr=0.01"])
        assert cfg.batch_size == 16
        assert cfg.base_lr == pytest.approx(0.01)
        assert cfg.point_num == 20480  # untouched default

    def test_replace(self):
        cfg = default_config().replace(nms_iou=0.5)
        assert cfg.nms_iou == 0.5
        assert default_config().nms_iou == 0.25  # frozen original

    def test_removed_knobs_are_rejected(self):
        """Removed knobs are gone: a stale --flag must error, not be
        silently dropped."""
        for flag in ("--scatter_precision=exact", "--samlp=off"):
            with pytest.raises(SystemExit):
                config_from_args([flag])

    def test_every_default_is_a_cli_override(self):
        cfg = config_from_args(["--bq_precision=fast_bf16", "--remat=True"])
        assert cfg.bq_precision == "fast_bf16" and cfg.remat is True
        assert cfg.replace(bq_precision="exact", remat=False) == default_config()

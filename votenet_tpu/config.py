"""Framework configuration.

The reference keeps its constants in a 6-line module
(``/root/reference/config.py:1-6``) plus hard-coded values scattered through
``run.py`` (batch size, LR schedule, data paths) and ``model.py`` (NMS IoU).
Here everything lives in one frozen dataclass with CLI override support, with
defaults equal to the reference values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """All knobs of the framework; defaults replicate the reference recipe."""

    # --- model constants (reference config.py:1-6) ---
    point_num: int = 20480       # POINT_NUM: input points per scene
    num_heading_bin: int = 12    # NH: heading bins
    num_size_cluster: int = 10   # NS: size classes
    num_class: int = 10          # NC: semantic classes
    positive_thres: float = 0.3  # POSITIVE_THRES: proposal<->GT center dist
    negative_thres: float = 0.6  # NEGATIVE_THRES
    proposal_num: int = 256      # PROPOSAL_NUM

    # --- fixed-shape padding (XLA compiles static shapes; the reference
    # uses variable-length GT tensors padded per-batch, run.py:62-64) ---
    max_gt_boxes: int = 64       # static GT-box axis; reference pads to the
                                 # per-batch max with edge (replicated) boxes

    # --- backbone architecture (reference model.py:39-49) ---
    sa_npoints: Tuple[int, ...] = (2048, 1024, 512, 256)
    sa_radii: Tuple[float, ...] = (0.2, 0.4, 0.8, 1.2)
    sa_nsamples: Tuple[int, ...] = (64, 64, 64, 64)
    sa_mlps: Tuple[Tuple[int, ...], ...] = (
        (64, 64, 128),
        (128, 128, 256),
        (128, 128, 256),
        (128, 128, 256),
    )
    fp_mlps: Tuple[Tuple[int, ...], ...] = ((256, 256), (256, 256))
    vote_units: Tuple[int, ...] = (256, 256, 256 + 3)  # model.py:54
    proposal_radius: float = 0.3       # model.py:89-93
    proposal_nsample: int = 64
    proposal_mlp: Tuple[int, ...] = (128, 128, 128)
    proposal_mlp2_hidden: Tuple[int, ...] = (128, 128)  # + head channels

    # --- inference (reference model.py:97) ---
    nms_iou: float = 0.25
    max_detections: int = 256    # static cap on NMS survivors (= proposal_num)

    # --- training recipe (reference run.py:11,113,130,134; model.py:241-249) ---
    batch_size: int = 2
    base_lr: float = 1e-3
    lr_schedule: Tuple[Tuple[int, float], ...] = ((80, 1e-4), (120, 1e-5))
    grad_clip_avg_norm: float = 0.5
    max_epoch: int = 260
    eval_every_k_epochs: int = 5
    augment_x: int = 5           # dataset.py:29 — cached augmentations/scene

    # --- loss weights (reference model.py:207,231) ---
    w_obj: float = 0.5
    w_box: float = 1.0
    w_sem: float = 0.1
    w_heading_cls: float = 0.1
    w_size_cls: float = 0.1

    # --- numerics / performance ---
    bn_momentum: float = 0.9     # tensorpack BatchNorm default decay
    bn_eps: float = 1e-5
    compute_dtype: str = "float32"   # "bfloat16" to run the MLPs in bf16
    mixed_precision: bool = False    # f32 coordinates/sa1/voting + bf16 for
                                     # the wide sa2+/FP/proposal feature
                                     # gathers and matmuls (the recipe from
                                     # the bf16 post-mortem, DESIGN.md; only
                                     # meaningful with compute_dtype=float32)
    use_pallas: bool = True      # the Pallas-Triton FPS / ball-query kernels
                                 # on a GPU; False forces the XLA twins
                                 # everywhere (applied at entry points via
                                 # ops.dispatch.apply_config)
    bq_precision: str = "exact"  # ball-query distance form: "exact" (the
                                 # oracle's f32 difference form -> reference-
                                 # identical hit sets) or "fast_bf16" (matmul
                                 # expansion, cm-scale boundary band — see
                                 # the note in ops/grouping.py)
    gather_packing: str = "none"  # SA-layer train gather transport: "none"
                                 # (f32 rows, full parity) or "bf16_hilo"
                                 # (hi+lo bf16 coordinate pairs + bf16
                                 # features: half the grouped-tensor bytes;
                                 # ~0.4% feature rounding, coords exact to
                                 # ~0.06 mm; backbone layers only — see
                                 # ops/dispatch.py gather_packing)
    remat: bool = False          # rematerialize SA blocks in backward: a
                                 # memory knob for batches that don't
                                 # otherwise fit

    # --- data (reference run.py:99,129) ---
    # GT-box rejection criterion (dataset.py:282). The reference tests
    # ``len(inds) < 5`` where inds is a boolean mask with one entry per
    # 2D-frustum point — i.e. it rejects boxes whose 2D frustum contains <5
    # points and never uses the in-3D-box count ("frustum", parity default).
    # "in_box" is the stricter, probably-intended criterion: <5 points
    # inside the 3D box (via Delaunay in-hull, sunutils.py:199-209).
    reject_mode: str = "frustum"
    data_root: str = "/data/mysunrgbd"
    cache_dir: Optional[str] = None
    train_idx_range: Tuple[int, int] = (5051, 10336)  # [lo, hi)
    val_idx_range: Tuple[int, int] = (1, 5051)

    # --- parallelism (new; the reference is single-GPU, SURVEY §2.3) ---
    mesh_shape: Tuple[int, ...] = (-1,)  # 1-D data-parallel mesh over "data";
                                         # -1 = all remaining devices
    mesh_axis_names: Tuple[str, ...] = ("data",)

    @property
    def num_proposal_channels(self) -> int:
        """Head channel count: 5 + 2*NH + 4*NS + NC (= 79), model.py:91."""
        return 5 + 2 * self.num_heading_bin + 4 * self.num_size_cluster + self.num_class

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config(**overrides) -> Config:
    """The reference training configuration, with optional overrides."""
    return Config(**overrides)


def tiny_config(**overrides) -> Config:
    """Scaled-down architecture for smoke tests / CI (same topology)."""
    base = dict(
        point_num=256,
        sa_npoints=(64, 32, 16, 8),
        sa_nsamples=(8, 8, 8, 8),
        sa_mlps=((16, 16, 32), (32, 32, 64), (32, 32, 64), (32, 32, 64)),
        fp_mlps=((64, 64), (64, 64)),
        vote_units=(64, 64, 64 + 3),
        proposal_nsample=8,
        proposal_mlp=(32, 32, 32),
        proposal_mlp2_hidden=(32, 32),
        proposal_num=16,
        max_gt_boxes=8,
    )
    base.update(overrides)
    return Config(**base)


def config_from_args(
    argv: Optional[Sequence[str]] = None, base: Optional[Config] = None
) -> Config:
    """Build a Config from ``--key=value`` CLI overrides.

    The reference has no flag system at all (SURVEY §5); this provides one
    with defaults identical to the hard-coded reference values. ``base``
    supplies the starting values (e.g. a tiny preset) instead of the
    dataclass defaults.
    """
    import argparse

    base = base or Config()

    def _bool(v: str) -> bool:
        if v.lower() in ("1", "true", "yes", "on"):
            return True
        if v.lower() in ("0", "false", "no", "off"):
            return False
        raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")

    def _tuple_parser(elem_type):
        def parse(v: str):
            try:
                return tuple(elem_type(x) for x in v.split(",") if x != "")
            except ValueError as e:
                raise argparse.ArgumentTypeError(
                    f"expected comma-separated {elem_type.__name__}s, got {v!r}"
                ) from e

        return parse

    parser = argparse.ArgumentParser(description="votenet_tpu configuration")
    for field in dataclasses.fields(Config):
        default = getattr(base, field.name)
        if isinstance(field.default, bool):
            # NB: bare type=bool would treat "--flag=False" as truthy
            parser.add_argument(f"--{field.name}", type=_bool, default=default)
        elif isinstance(field.default, (int, float, str)):
            parser.add_argument(
                f"--{field.name}", type=type(field.default), default=default
            )
        elif (
            isinstance(field.default, tuple)
            and field.default
            and all(isinstance(x, (int, float, str)) for x in field.default)
            and len({type(x) for x in field.default}) == 1
        ):
            # flat homogeneous tuples are comma-separated on the CLI, e.g.
            # --train_idx_range=5051,5101  --mesh_shape=2,4  --sa_radii=0.2,...
            # (nested tuples like sa_mlps / lr_schedule stay code-only)
            parser.add_argument(
                f"--{field.name}",
                type=_tuple_parser(type(field.default[0])),
                default=tuple(default),
            )
    # strict: a misspelled override (--use_palas=...) must error, not be
    # silently dropped — callers pass exactly the leftover argv that is
    # supposed to consist of Config overrides
    args = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    return base.replace(**{k: v for k, v in vars(args).items() if k in known})

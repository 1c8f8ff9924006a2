"""The VoteNet model: backbone + deep Hough voting + proposal head.

Rebuild of the reference graph (``/root/reference/model.py``):
4 SA layers + 2 FP layers (model.py:39-49), a 3-layer shared voting MLP that
offsets both seed coordinates and features (model.py:53-60), and a proposal
SA module whose FPS runs on the seeds while gathering the votes
(model.py:89-93) ending in the 79-channel head:

  [0:2]  objectness logits          [5+2NH : 5+2NH+NS]       size-class logits
  [2:5]  center offset              [5+2NH+NS : 5+2NH+4NS]   size residuals (NSx3)
  [5:5+NH]      heading-class logits  [-NC:]                 semantic logits
  [5+NH:5+2NH]  heading residuals

(model.py:95,115-125,170,186,191,197,203,210; NH=12, NS=NC=10 -> 79.)

Functional-JAX design: ``VoteNet.init`` builds a params/batch_stats pytree;
``apply`` is pure, jit/pjit-able, and returns an end-points dict consumed by
:mod:`votenet_tpu.models.losses` (training) and
:mod:`votenet_tpu.models.decode` (inference). There is no training/inference
graph fork inside the model (the reference rebuilds its graph per tower);
decode + NMS are separate pure functions applied on top.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax.numpy as jnp
from jax.sharding import Mesh

from votenet_tpu.config import Config
from votenet_tpu.models.layers import BatchNorm, Dense, Module, relu, remat
from votenet_tpu.models.pointnet2 import (
    BN_EPS,
    BN_MOMENTUM,
    PointNetFPModule,
    PointNetSAModule,
)


class VotingModule(Module):
    """Shared FC stack producing per-seed (xyz, feature) offsets.

    Mirrors model.py:53-60: widths (256, 256, 259), BN+ReLU on all but the
    last layer; the BN statistics are over the flattened (batch x seed) axis
    exactly as the reference's FullyConnected-on-reshaped-input.
    """

    units: tuple
    dtype: jnp.dtype = jnp.float32
    bn_momentum: float = BN_MOMENTUM
    bn_eps: float = BN_EPS

    def __call__(self, seeds: jnp.ndarray, train: bool) -> jnp.ndarray:
        x = seeds
        for i, w in enumerate(self.units):
            x = Dense(w, dtype=self.dtype, name=f"voting{i}")(x)
            if i < len(self.units) - 1:
                x = BatchNorm(
                    use_running_average=not train,
                    momentum=self.bn_momentum,
                    epsilon=self.bn_eps,
                    dtype=self.dtype,
                    name=f"voting{i}_bn",
                )(x)
                x = relu(x)
        return x


class VoteNet(Module):
    """Full VoteNet forward pass -> end-points dict.

    ``sp_mesh`` enables point-axis (SP) sharding for the large-N backbone:
    every SA layer whose INPUT cloud holds >= ``sp_min_points`` points (and
    divides the ``sp_axis`` mesh size) runs its O(N) grouping stage
    point-sharded (parallel/point_sharded.py) — bit-identical outputs,
    shard-local working sets, so the reachable point count scales with the
    mesh. With the default config only sa1 (N=20480) qualifies; every
    downstream tensor is O(npoint)<=2048 and stays replicated over sp_axis.
    ``sp_batch_axis`` names the data-parallel mesh axis for a combined
    dp x sp layout (exercised in __graft_entry__.dryrun_multichip and
    tests/test_point_sharded.py).
    """

    config: Config
    sp_mesh: Optional[Mesh] = None
    sp_axis: str = "points"
    sp_batch_axis: Optional[str] = None
    sp_min_points: int = 4096

    def __call__(self, points: jnp.ndarray, train: bool = False) -> Dict[str, Any]:
        cfg = self.config
        dtype = jnp.dtype(cfg.compute_dtype)
        # Mixed precision (Config.mixed_precision): every COORDINATE path
        # stays f32 (sa1 entirely — its features ARE raw coordinates — plus
        # all FPS/ball-query/center math and the voting stack, whose output
        # offsets feed vote coordinates); the wide sa2+/FP/proposal feature
        # gathers + matmuls run bf16 via the split CenteredDense. This is
        # the recipe the bf16-everywhere post-mortem called for (DESIGN.md):
        # features are most of the bytes the model moves.
        mixed = cfg.mixed_precision and dtype == jnp.float32
        feat_dtype = jnp.bfloat16 if mixed else dtype

        l0_xyz = points
        l0_points = points  # the reference feeds xyz as the l0 features (model.py:35-36)

        # optional rematerialization: recompute SA activations in the
        # backward pass instead of keeping the (B, npoint, nsample, C)
        # grouped tensors alive across the whole graph
        # static_argnums index the call's arguments (xyz, points, train)
        sa_cls = remat(PointNetSAModule, static_argnums=(2,)) if cfg.remat else PointNetSAModule

        bn_kw = dict(bn_momentum=cfg.bn_momentum, bn_eps=cfg.bn_eps)
        xyz, feats = l0_xyz, l0_points
        sa_out = []
        n_in = cfg.point_num
        for i in range(4):
            sp_on = (
                self.sp_mesh is not None
                and n_in >= self.sp_min_points
                and n_in % self.sp_mesh.shape[self.sp_axis] == 0
            )
            n_in = cfg.sa_npoints[i]
            xyz, feats, _ = sa_cls(
                sp_mesh=self.sp_mesh if sp_on else None,
                sp_axis=self.sp_axis,
                sp_batch_axis=self.sp_batch_axis,
                npoint=cfg.sa_npoints[i],
                radius=cfg.sa_radii[i],
                nsample=cfg.sa_nsamples[i],
                mlp=cfg.sa_mlps[i],
                dtype=feat_dtype if (mixed and i > 0) else dtype,
                split_coords=mixed and i > 0,
                # backbone coordinates derive only from the param-free input
                # cloud -> no gradient (PointNetSAModule.coord_grad). The
                # proposal layer below keeps the default (its xyz are votes,
                # which carry gradient).
                coord_grad=False,
                name=f"sa{i + 1}",
                **bn_kw,
            )(xyz, feats, train)
            sa_out.append((xyz, feats))

        (l1_xyz, l1_points), (l2_xyz, l2_points), (l3_xyz, l3_points), (l4_xyz, l4_points) = sa_out

        # FP stays f32 even in mixed mode: its tensors are small (<= 1024
        # positions) and the seed features feed the vote/proposal geometry
        l3_points = PointNetFPModule(
            cfg.fp_mlps[0], dtype=dtype, name="fp1", **bn_kw
        )(l3_xyz, l4_xyz, l3_points.astype(dtype), l4_points.astype(dtype), train)
        seeds_points = PointNetFPModule(
            cfg.fp_mlps[1], dtype=dtype, name="fp2", **bn_kw
        )(l2_xyz, l3_xyz, l2_points.astype(dtype), l3_points, train)
        seeds_xyz = l2_xyz

        # Voting: offsets applied to the concatenated (xyz, feature) seed
        # state — votes shift coordinates AND features (model.py:60).
        # Mixed mode: the voting stack stays f32 (its output offsets the
        # vote COORDINATES; the seed tensor is small — 1024 positions)
        seed_state = jnp.concatenate(
            [seeds_xyz, seeds_points.astype(dtype)], axis=2
        )
        offset = VotingModule(tuple(cfg.vote_units), dtype=dtype, name="voting", **bn_kw)(
            seed_state, train
        )
        votes = seed_state + offset
        votes_xyz = votes[:, :, :3]
        votes_points = votes[:, :, 3:]

        # Proposal: FPS on seeds, gather votes (model.py:89-93, utils.py:42-43)
        # the proposal module (and its 79-channel head, whose outputs are
        # center/heading/size RESIDUALS) stays f32 in mixed mode
        proposals_xyz, proposals_output, _ = PointNetSAModule(
            npoint=cfg.proposal_num,
            radius=cfg.proposal_radius,
            nsample=cfg.proposal_nsample,
            mlp=cfg.proposal_mlp,
            mlp2=tuple(cfg.proposal_mlp2_hidden) + (cfg.num_proposal_channels,),
            dtype=dtype,
            name="proposal",
            **bn_kw,
        )(votes_xyz, votes_points, train, sample_xyz=seeds_xyz)

        return {
            "seeds_xyz": seeds_xyz,
            "seeds_points": seeds_points,
            "votes_xyz": votes_xyz,
            "votes_points": votes_points,
            "proposals_xyz": proposals_xyz,
            "proposals_output": proposals_output.astype(jnp.float32),
            "obj_scores": proposals_output[..., :2].astype(jnp.float32),
        }


def init_votenet(rng, config: Config):
    """Initialize (params, batch_stats) for a VoteNet."""
    model = VoteNet(config)
    dummy = jnp.zeros((1, config.point_num, 3), dtype=jnp.float32)
    variables = model.init(rng, dummy, train=False)
    return model, variables

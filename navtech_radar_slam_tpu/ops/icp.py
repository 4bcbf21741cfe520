"""Submap-to-scan ICP for loop verification on the accelerator.

Reproduces the reference's loop check (doICPVirtualRelative,
laserPosegraphOptimization.cpp:355-406): align the loop-candidate keyframe
cloud against a stacked submap of its neighbours, accept iff the fitness
(mean squared correspondence distance, PCL getFitnessScore semantics) is
below 0.3 after convergence, and emit the relative pose as a loop factor.

Design decisions:
  * nearest neighbours by brute force over the whole target set instead of
    PCL's KD-tree: at these point counts (<=1k query, <=8k target) one fused
    distance-and-reduce pass needs no tree build and no data-dependent
    control flow;
  * bounded `lax.while_loop` with a convergence test (identical result to
    a fixed-iteration freeze, but converged alignments — the common case,
    typically 10-30 of the reference's 100 iterations — stop paying for
    the remainder); shapes stay static;
  * planar SE(2) alignment (radar clouds are z≈0; the reference runs 3-DoF
    ICP in disguise — its clouds carry z=0 + the ScanContext lift);
  * closed-form weighted Horn update per iteration (no linear solve).

Unlike the reference, ICP starts from the ScanContext yaw estimate instead
of identity (the reference computes and discards it,
laserPosegraphOptimization.cpp:561-562) — large-rotation loops converge
where identity-start ICP would fall into a local minimum.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from navtech_radar_slam_tpu.config import IcpConfig
from navtech_radar_slam_tpu.utils import geometry as geo


class IcpResult(NamedTuple):
    rel_pose: jnp.ndarray     # (3,) SE(2) aligning src into tgt frame
    fitness: jnp.ndarray      # () mean squared corr distance (PCL semantics)
    num_corr: jnp.ndarray     # () int32 correspondences in final iteration
    converged: jnp.ndarray    # () bool step size fell below epsilon
    accepted: jnp.ndarray     # () bool converged && fitness <= thresh


def nearest_neighbors(
    src: jnp.ndarray, tgt: jnp.ndarray, tgt_valid: jnp.ndarray
):
    """Brute-force NN: returns (nn_sqdist (Nq,), nn_idx (Nq,)).

    Subtract-square form: the f32 differences keep full precision where
    the |a|² + |b|² - 2ab expansion cancels catastrophically at 200 m
    ranges (negative d² and bogus correspondences), and with a contraction
    depth
    of 2 there is no matrix product for tensor cores to take.  XLA fuses
    the broadcast into the min/argmin reductions.  Ties go to the lowest
    target index; with no valid target the distance is +inf."""
    dx = src[:, 0:1] - tgt[None, :, 0]
    dy = src[:, 1:2] - tgt[None, :, 1]
    d2 = jnp.where(tgt_valid[None, :], dx * dx + dy * dy, jnp.inf)
    return jnp.min(d2, axis=-1), jnp.argmin(d2, axis=-1)


def _weighted_se2_horn(src, dst, w):
    """Closed-form weighted SE(2) alignment: R, t minimizing Σ w |R s + t - d|²."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    cs = jnp.sum(w[:, None] * src, axis=0) / wsum
    cd = jnp.sum(w[:, None] * dst, axis=0) / wsum
    s0 = src - cs
    d0 = dst - cd
    dot = jnp.sum(w * (s0[:, 0] * d0[:, 0] + s0[:, 1] * d0[:, 1]))
    crs = jnp.sum(w * (s0[:, 0] * d0[:, 1] - s0[:, 1] * d0[:, 0]))
    theta = jnp.arctan2(crs, dot)
    c, s = jnp.cos(theta), jnp.sin(theta)
    t = cd - jnp.stack([c * cs[0] - s * cs[1], s * cs[0] + c * cs[1]])
    return jnp.stack([t[0], t[1], theta])


def icp_se2(
    src: jnp.ndarray,
    src_valid: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_valid: jnp.ndarray,
    init_pose: jnp.ndarray,
    cfg: IcpConfig,
) -> IcpResult:
    """Align src onto tgt starting from init_pose ([x, y, theta]).

    Mirrors the reference's PCL configuration: max correspondence distance
    150 m, 100 iterations, transformation epsilon 1e-6, euclidean fitness
    epsilon 1e-6, fitness gate 0.3 (laserPosegraphOptimization.cpp:376-389).
    Convergence is either criterion (PCL DefaultConvergenceCriteria): the
    transform step below cfg.epsilon, or the mean-squared correspondence
    error changing by less than cfg.euclidean_fitness_eps between
    iterations."""
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist

    def cond(carry):
        _, converged, it, _ = carry
        return (~converged) & (it < cfg.max_iters)

    def body(carry):
        pose, _, it, prev_mse = carry
        moved = geo.se2_apply(pose, src)
        nn_d2, nn_idx = nearest_neighbors(moved, tgt, tgt_valid)
        w = (src_valid & (nn_d2 < max_d2)).astype(jnp.float32)
        mse = jnp.sum(w * nn_d2) / jnp.maximum(jnp.sum(w), 1.0)
        matched = tgt[nn_idx]
        upd = _weighted_se2_horn(moved, matched, w)
        new_pose = geo.se2_mul(upd, pose)
        step = jnp.abs(new_pose - pose)
        small = (step[0] < cfg.epsilon) & (step[1] < cfg.epsilon) & (
            step[2] < cfg.epsilon
        )
        dmse = jnp.abs(mse - prev_mse)
        mse_static = dmse < cfg.euclidean_fitness_eps
        if cfg.rel_fitness_eps > 0 and cfg.fitness_metric != "pcl":
            # relative plateau: NN-assignment oscillation at the optimum
            # keeps the step above epsilon while mse is static to ~0.1 %;
            # without this every verification exhausts max_iters (see
            # IcpConfig.rel_fitness_eps).  Disabled in fitness_metric="pcl"
            # — the reference-parity mode keeps PCL's strict criteria only.
            mse_static = mse_static | (dmse < cfg.rel_fitness_eps * mse)
        return (new_pose, small | mse_static, it + 1, mse)

    pose, converged, _, _ = jax.lax.while_loop(
        cond, body,
        (init_pose, jnp.asarray(False), jnp.asarray(0, jnp.int32),
         jnp.asarray(jnp.inf, jnp.float32)),
    )

    # final fitness over in-range correspondences.  "pcl": PCL
    # getFitnessScore = mean squared NN distance (reference cpp:389 gates it
    # at 0.3).  "whitened" (default): each squared distance normalized by
    # its expected variance under the anisotropic radar noise model —
    # 2 * (sigma_r² + (r·sigma_az)²), r the query point's sensing range
    # (src is in its keyframe's sensor frame; the factor 2 covers the
    # independent noise of both clouds) — so the gate is scale-free:
    # ~1 for a true, converged loop at any range, >> 1 for a false one.
    moved = geo.se2_apply(pose, src)
    nn_d2, _ = nearest_neighbors(moved, tgt, tgt_valid)
    in_range = src_valid & (nn_d2 < max_d2)
    n = jnp.sum(in_range)
    if cfg.fitness_metric == "whitened":
        r2 = jnp.sum(src * src, axis=-1)
        sig2 = cfg.whiten_sigma_range**2 + r2 * cfg.whiten_sigma_azimuth_rad**2
        contrib = nn_d2 / (2.0 * sig2)
    else:
        contrib = nn_d2
    fitness = jnp.sum(jnp.where(in_range, contrib, 0.0)) / jnp.maximum(n, 1)
    # acceptance: PCL's hasConverged() (cpp:389) is true even when the run
    # merely exhausted max iterations (CONVERGENCE_CRITERIA_ITERATIONS with
    # failure_after_max_iter_ = false, the default) — so the reference's
    # gate is effectively fitness-only.  Requiring the strict step/mse
    # criterion here rejected ~half the true loops (oscillating NN
    # assignments keep the step above epsilon at tiny fitness); `converged`
    # still reports the strict flag for diagnostics.
    accepted = (fitness <= cfg.fitness_thresh) & (n >= 10)
    return IcpResult(
        rel_pose=pose,
        fitness=fitness,
        num_corr=n.astype(jnp.int32),
        converged=converged,
        accepted=accepted,
    )

"""Voxel-grid downsampling as a static-shape, jittable masking op.

The reference voxel-filters three clouds with pcl::VoxelGrid: the stored
keyframe cloud at 0.4 m (laserPosegraphOptimization.cpp:482-484, 687-689),
the stacked loop submap at 0.4 m (cpp:347-351) and the published map at
0.2 m (cpp:691-692).  PCL emits a *dynamically sized* cloud of per-cell
centroids — impossible under XLA's static shapes — so the formulation
here is a *mask*: keep exactly one representative point per occupied
cell (the lowest-index valid point), leaving shapes untouched.

Divergence note: PCL keeps the cell centroid; we keep a representative
point, displaced from the centroid by at most voxel/sqrt(2).  At the 0.4 m
cells and ≥0.25 m radar feature noise of this pipeline the difference is
second-order; what matters for the ICP fitness gate is the *density cap*
(one point per cell), which is preserved exactly.

Implementation: one lexicographic `lax.sort` over (cell_x, cell_y, index)
triples — O(N log N) on the VPU, no scatter conflicts, deterministic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: sentinel cell coordinate for invalid points (sorts after all real cells;
#: real cells are bounded by sensor range / voxel ≪ 2^30)
_SENTINEL = jnp.int32(1 << 30)


def voxel_dedup_mask(
    pts: jnp.ndarray, valid: jnp.ndarray, voxel: float
) -> jnp.ndarray:
    """(N,) bool mask keeping one valid point per voxel cell.

    pts: (N, 2) float; valid: (N,) bool; voxel: cell edge in meters
    (<= 0 disables: returns ``valid`` unchanged).  Within a cell the valid
    point with the lowest index wins (deterministic)."""
    if voxel <= 0:
        return valid
    cx = jnp.floor(pts[:, 0] / voxel).astype(jnp.int32)
    cy = jnp.floor(pts[:, 1] / voxel).astype(jnp.int32)
    cx = jnp.where(valid, cx, _SENTINEL)
    cy = jnp.where(valid, cy, _SENTINEL)
    idx = jnp.arange(pts.shape[0], dtype=jnp.int32)
    sx, sy, sidx = jax.lax.sort((cx, cy, idx), num_keys=2)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1])]
    )
    keep_sorted = first & (sx != _SENTINEL)
    keep = jnp.zeros_like(valid).at[sidx].set(keep_sorted)
    return keep & valid

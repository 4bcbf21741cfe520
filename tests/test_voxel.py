"""Unit tests for the static-shape voxel downsampling mask (ops/voxel.py) —
the static-shape equivalent of the reference's pcl::VoxelGrid filters
(laserPosegraphOptimization.cpp:347-351, 482-484, 687-692)."""

import jax.numpy as jnp
import numpy as np

from navtech_radar_slam_tpu.ops.voxel import voxel_dedup_mask


def test_one_point_per_cell():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-50, 50, size=(2000, 2)).astype(np.float32)
    valid = np.ones(2000, bool)
    valid[1500:] = False
    keep = np.asarray(voxel_dedup_mask(jnp.asarray(pts), jnp.asarray(valid), 1.0))
    assert not keep[1500:].any(), "invalid points must never be kept"
    cells = np.floor(pts[keep] / 1.0).astype(np.int64)
    assert len(np.unique(cells, axis=0)) == keep.sum(), "duplicate cells kept"
    # every occupied (valid) cell keeps exactly one representative
    occ = np.unique(np.floor(pts[valid] / 1.0).astype(np.int64), axis=0)
    assert keep.sum() == len(occ)


def test_lowest_index_wins_and_negatives():
    pts = jnp.asarray([
        [-0.35, -0.35],   # cell (-1,-1)
        [-0.05, -0.05],   # cell (-1,-1) duplicate (floor, not trunc)
        [0.05, 0.05],     # cell (0,0)
        [0.30, 0.30],     # cell (0,0) duplicate
    ], jnp.float32)
    valid = jnp.ones(4, bool)
    keep = np.asarray(voxel_dedup_mask(pts, valid, 0.4))
    np.testing.assert_array_equal(keep, [True, False, True, False])
    # first point invalid -> its duplicate becomes the representative
    keep2 = np.asarray(
        voxel_dedup_mask(pts, jnp.asarray([False, True, True, True]), 0.4)
    )
    np.testing.assert_array_equal(keep2, [False, True, True, False])


def test_disabled_voxel_passthrough():
    pts = jnp.zeros((8, 2), jnp.float32)
    valid = jnp.asarray([True, False] * 4)
    keep = np.asarray(voxel_dedup_mask(pts, valid, 0.0))
    np.testing.assert_array_equal(keep, np.asarray(valid))


def test_density_cap_under_stacking():
    """Stacked revisits of the same wall collapse to the single-pass density
    — the property the ICP fitness gate relies on (one point per 0.4 m)."""
    # cell centers (points straddling a cell boundary legitimately split)
    base = np.stack(
        [0.2 + np.arange(51) * 0.4, np.full(51, 0.2)], 1
    ).astype(np.float32)
    rng = np.random.default_rng(1)
    stacked = np.concatenate([
        base + rng.normal(0, 0.03, base.shape).astype(np.float32)
        for _ in range(10)
    ])
    keep = np.asarray(voxel_dedup_mask(
        jnp.asarray(stacked), jnp.ones(len(stacked), bool), 0.4
    ))
    assert keep.sum() <= 1.3 * 51, int(keep.sum())

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from navtech_radar_slam_tpu.config import IcpConfig
from navtech_radar_slam_tpu.ops import icp
from navtech_radar_slam_tpu.utils import geometry as geo

CFG = dataclasses.replace(IcpConfig(), max_iters=50)


def cloud(rng, n=400):
    return rng.uniform(-60, 60, size=(n, 2)).astype(np.float32)


def pad(arr, n):
    out = np.zeros((n, arr.shape[1]), np.float32)
    out[: len(arr)] = arr
    valid = np.zeros(n, bool)
    valid[: len(arr)] = True
    return jnp.asarray(out), jnp.asarray(valid)


def test_icp_recovers_transform(rng):
    tgt_np = cloud(rng)
    pose_true = np.array([2.0, -1.5, 0.25], np.float32)
    # src such that applying pose_true to src gives tgt: src = T^{-1} tgt
    inv = np.asarray(geo.se2_inv(jnp.asarray(pose_true)))
    src_np = np.asarray(geo.se2_apply(jnp.asarray(inv), jnp.asarray(tgt_np)))
    src_np = src_np + rng.normal(0, 0.02, src_np.shape).astype(np.float32)

    src, sv = pad(src_np, 512)
    tgt, tv = pad(tgt_np, 512)
    res = icp.icp_se2(src, sv, tgt, tv, jnp.zeros(3), CFG)
    assert bool(res.converged)
    assert bool(res.accepted), float(res.fitness)
    np.testing.assert_allclose(np.asarray(res.rel_pose), pose_true, atol=0.05)


def test_icp_large_rotation_needs_init(rng):
    """120-degree offset: identity start fails, yaw-informed start succeeds —
    the reason we consume the ScanContext yaw the reference discards."""
    tgt_np = cloud(rng, 500)
    th = 2.1
    pose_true = np.array([1.0, 0.5, th], np.float32)
    inv = np.asarray(geo.se2_inv(jnp.asarray(pose_true)))
    src_np = np.asarray(geo.se2_apply(jnp.asarray(inv), jnp.asarray(tgt_np)))

    src, sv = pad(src_np, 512)
    tgt, tv = pad(tgt_np, 512)

    res_id = icp.icp_se2(src, sv, tgt, tv, jnp.zeros(3), CFG)
    err_id = abs(float(geo.wrap_angle(res_id.rel_pose[2] - th)))

    init = jnp.asarray([0.0, 0.0, th - 0.08], jnp.float32)
    res_in = icp.icp_se2(src, sv, tgt, tv, init, CFG)
    err_in = abs(float(geo.wrap_angle(res_in.rel_pose[2] - th)))
    assert err_in < 0.02
    np.testing.assert_allclose(np.asarray(res_in.rel_pose)[:2], pose_true[:2], atol=0.05)
    # identity start lands in a worse alignment for random clouds
    assert err_in < err_id


def test_icp_rejects_unrelated_clouds(rng):
    a, av = pad(cloud(rng), 512)
    b, bv = pad(cloud(np.random.default_rng(99)), 512)
    res = icp.icp_se2(a, av, b, bv, jnp.zeros(3), CFG)
    # unrelated uniform clouds: fitness far above the 0.3 gate
    assert float(res.fitness) > CFG.fitness_thresh
    assert not bool(res.accepted)


def test_icp_partial_overlap(rng):
    """Submap much larger than scan: still aligns (the loop use case)."""
    world = rng.uniform(-150, 150, size=(3000, 2)).astype(np.float32)
    near = world[np.linalg.norm(world - np.array([40, 20]), axis=1) < 60]
    pose_true = np.array([-1.0, 2.0, 0.15], np.float32)
    inv = np.asarray(geo.se2_inv(jnp.asarray(pose_true)))
    src_np = np.asarray(geo.se2_apply(jnp.asarray(inv), jnp.asarray(near)))
    src, sv = pad(src_np, 1024)
    tgt, tv = pad(world, 4096)
    # start from a coarse yaw estimate, as the loop pipeline does with the
    # ScanContext shift (one sector = 6 deg resolution)
    init = jnp.asarray([0.0, 0.0, 0.12], jnp.float32)
    res = icp.icp_se2(src, sv, tgt, tv, init, CFG)
    np.testing.assert_allclose(np.asarray(res.rel_pose), pose_true, atol=0.05)


@pytest.mark.parametrize("nq,nt", [(7, 33), (300, 900), (1024, 4096)])
def test_nearest_neighbors_matches_float64_brute_force(rng, nq, nt):
    """Subtract-square NN at ±200 m ranges, invalid targets included,
    against a float64 NumPy brute force: same indices (no ties occur in
    continuous random clouds) and distances to f32 rounding."""
    from navtech_radar_slam_tpu.ops.reference import nearest_neighbors_np

    src = rng.uniform(-200, 200, (nq, 2)).astype(np.float32)
    tgt = rng.uniform(-200, 200, (nt, 2)).astype(np.float32)
    tv = rng.random(nt) > 0.2
    d, i = icp.nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt),
                                 jnp.asarray(tv))
    d_ref, i_ref = nearest_neighbors_np(src, tgt, tv)
    np.testing.assert_array_equal(np.asarray(i), i_ref)
    assert tv[np.asarray(i)].all()
    np.testing.assert_allclose(np.asarray(d), d_ref, rtol=1e-5)


def test_nearest_neighbors_all_targets_invalid(rng):
    src = jnp.asarray(rng.uniform(-10, 10, (64, 2)), jnp.float32)
    tgt = jnp.asarray(rng.uniform(-10, 10, (128, 2)), jnp.float32)
    d, _ = icp.nearest_neighbors(src, tgt, jnp.zeros(128, bool))
    assert np.isinf(np.asarray(d)).all()

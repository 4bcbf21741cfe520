"""Tests that need an NVIDIA GPU (marker ``gpu``; see conftest.py).

They skip on the CPU suite and run on the card with

    NRS_TESTS_GPU=1 python -m pytest tests/test_gpu_only.py

Both run the shipped default config, whose f32 contractions without a
pinned precision take TF32 on the card, and hold it to ground truth.
"""

import numpy as np
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu_backend")]


def test_full_slam_closes_loops_on_gpu_default_config():
    """End-to-end engine on the card with SHIPPED defaults (whitened
    fitness gate, voxel filters, deferred loop commits): loops close, the
    trajectory is finite and within 5 % of the path of ground truth."""
    import jax.numpy as jnp

    from navtech_radar_slam_tpu.config import SlamConfig
    from navtech_radar_slam_tpu.data import RadarSimulator
    from navtech_radar_slam_tpu.models.slam import SlamEngine
    from navtech_radar_slam_tpu.utils import geometry as geo
    from navtech_radar_slam_tpu.utils.metrics import ate_rmse

    cfg = SlamConfig()
    sim = RadarSimulator(cfg.radar)
    n = 60
    gt = sim.circuit_trajectory(n, radius=10.0, speed=6.0)
    scans = np.stack([sim.render(gt[i], noise_seed=i) for i in range(n)])
    eng = SlamEngine(cfg)
    for c0 in range(0, n, 12):
        eng.process_chunk(scans[c0:c0 + 12])
    assert eng.num_keyframes == n          # 1.5 m steps pass the 0.2 m gate
    assert len(eng.loops) >= 1
    traj = eng.trajectory()
    assert np.isfinite(traj).all()
    g0 = jnp.asarray(gt[0], jnp.float32)
    gt_rel = np.asarray(jnp.stack([
        geo.se2_between(g0, jnp.asarray(g, jnp.float32)) for g in gt]))
    path_len = np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1))
    assert ate_rmse(traj[:, :2, 3], gt_rel[:, :2]) < 0.05 * path_len


def test_odometry_short_sequence_on_gpu():
    """10-scan dead reckoning at the default config: ATE within 5 % of
    the path, as on the CPU (tests/test_odometry.py)."""
    from navtech_radar_slam_tpu.config import SlamConfig
    from navtech_radar_slam_tpu.data import RadarSimulator
    from navtech_radar_slam_tpu.models.odometry import RadarOdometry

    cfg = SlamConfig()
    sim = RadarSimulator(cfg.radar)
    gt = sim.random_trajectory(10, speed=4.0, seed=3)
    odo = RadarOdometry(cfg)
    est = np.asarray([odo.process(sim.render(gt[i], noise_seed=100 + i))[0]
                      for i in range(len(gt))])
    ate = np.sqrt((np.linalg.norm(est[:, :2] - gt[:, :2], axis=1) ** 2).mean())
    path_len = np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1))
    assert ate < 0.05 * path_len, f"ATE {ate:.3f} m over {path_len:.1f} m path"

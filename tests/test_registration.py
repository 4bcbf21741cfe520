import dataclasses

import jax.numpy as jnp
import numpy as np

from navtech_radar_slam_tpu.config import SlamConfig
from navtech_radar_slam_tpu.ops.features import MatchSet
from navtech_radar_slam_tpu.ops import registration as reg
from navtech_radar_slam_tpu.utils import geometry as geo


def make_matchset(rng, M=256, n_outliers=100, theta=0.08, t=(1.2, -0.4),
                  noise=0.05):
    """b = R a + t (+noise); outliers get random b."""
    a = rng.uniform(-60, 60, size=(M, 2))
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    b = a @ R.T + np.asarray(t) + rng.normal(0, noise, size=(M, 2))
    idx = rng.permutation(M)[:n_outliers]
    b[idx] = rng.uniform(-60, 60, size=(n_outliers, 2))
    valid = np.ones(M, bool)
    return MatchSet(
        src_xy=jnp.asarray(a, jnp.float32),
        dst_xy=jnp.asarray(b, jnp.float32),
        src_range=jnp.asarray(np.linalg.norm(a, axis=-1), jnp.float32),
        dst_range=jnp.asarray(np.linalg.norm(b, axis=-1), jnp.float32),
        weight=jnp.ones(M, jnp.float32),
        valid=jnp.asarray(valid),
    ), idx


def expected_rel(theta, t):
    """register convention: b = R a + t  ->  rel = (R^T, -R^T t, -theta)."""
    c, s = np.cos(theta), np.sin(theta)
    Rt = np.array([[c, s], [-s, c]])
    xr, yr = -Rt @ np.asarray(t)
    return np.array([xr, yr, -theta])


def test_registration_no_outliers(rng):
    cfg = SlamConfig().registration
    ms, _ = make_matchset(rng, n_outliers=0, noise=0.02)
    res = reg.register_scans(ms, cfg)
    exp = expected_rel(0.08, (1.2, -0.4))
    np.testing.assert_allclose(np.asarray(res.rel_pose), exp, atol=0.03)
    assert bool(res.ok)


def test_registration_40pct_outliers(rng):
    cfg = SlamConfig().registration
    ms, out_idx = make_matchset(rng, M=256, n_outliers=102)
    res = reg.register_scans(ms, cfg)
    exp = expected_rel(0.08, (1.2, -0.4))
    np.testing.assert_allclose(np.asarray(res.rel_pose)[:2], exp[:2], atol=0.06)
    assert abs(float(res.rel_pose[2]) - exp[2]) < 0.01
    # outliers mostly rejected
    inl = np.asarray(res.inlier_mask)
    assert inl[out_idx].mean() < 0.1
    assert int(res.num_inliers) > 80


def test_registration_70pct_outliers(rng):
    cfg = SlamConfig().registration
    ms, _ = make_matchset(rng, M=300, n_outliers=210)
    res = reg.register_scans(ms, cfg)
    exp = expected_rel(0.08, (1.2, -0.4))
    assert abs(float(res.rel_pose[2]) - exp[2]) < 0.02
    np.testing.assert_allclose(np.asarray(res.rel_pose)[:2], exp[:2], atol=0.15)


def test_registration_large_rotation(rng):
    cfg = SlamConfig().registration
    ms, _ = make_matchset(rng, M=256, n_outliers=60, theta=0.6, t=(3.0, 1.0))
    res = reg.register_scans(ms, cfg)
    exp = expected_rel(0.6, (3.0, 1.0))
    assert abs(float(res.rel_pose[2]) - exp[2]) < 0.02
    np.testing.assert_allclose(np.asarray(res.rel_pose)[:2], exp[:2], atol=0.15)


def test_registration_identity(rng):
    cfg = SlamConfig().registration
    ms, _ = make_matchset(rng, n_outliers=0, theta=0.0, t=(0.0, 0.0), noise=0.01)
    res = reg.register_scans(ms, cfg)
    np.testing.assert_allclose(np.asarray(res.rel_pose), 0.0, atol=0.02)


def test_gnc_weights_monotone():
    res2 = jnp.asarray([0.0, 0.5, 1.0, 2.0, 10.0], jnp.float32)
    w = reg._gnc_tls_weights(res2, jnp.asarray(1.0), 1.0)
    w = np.asarray(w)
    assert (np.diff(w) <= 1e-6).all()
    assert w[0] == 1.0 and w[-1] == 0.0


def test_constellation_descriptor_matches_scatter_reference():
    """The hat-basis contraction reproduces the bilinear scatter splat
    exactly (the contraction replaces a scatter with colliding indices;
    this is the fast path's correctness anchor)."""
    import numpy as np
    import jax.numpy as jnp

    from navtech_radar_slam_tpu.config import FeatureConfig
    from navtech_radar_slam_tpu.ops import features as F

    fcfg = FeatureConfig(max_features=48, desc_grid=8, desc_window=48.0)
    rng = np.random.default_rng(3)
    K, P, window = 48, fcfg.desc_grid, fcfg.desc_window
    xy = rng.uniform(-60, 60, (K, 2)).astype(np.float32)
    power = rng.uniform(0.1, 1.0, K).astype(np.float32)
    valid = rng.random(K) > 0.25

    cell = window / P
    want = np.zeros((K, P, P), np.float64)
    rngs = np.linalg.norm(xy, axis=-1)
    c = np.where(rngs > 1e-6, xy[:, 0] / np.maximum(rngs, 1e-6), 1.0)
    s = np.where(rngs > 1e-6, xy[:, 1] / np.maximum(rngs, 1e-6), 0.0)
    for i in range(K):
        for j in range(K):
            if not (valid[i] and valid[j]):
                continue
            d = xy[j] - xy[i]
            dx = c[i] * d[0] + s[i] * d[1]
            dy = -s[i] * d[0] + c[i] * d[1]
            w = power[j] * np.exp(-0.5 * (dx * dx + dy * dy) / (window * 0.5) ** 2)
            gx = dx / cell + P / 2 - 0.5
            gy = dy / cell + P / 2 - 0.5
            x0, y0 = int(np.floor(gx)), int(np.floor(gy))
            wx, wy = gx - x0, gy - y0
            for ox, oy, cw in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                               (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
                xi, yi = x0 + ox, y0 + oy
                if 0 <= xi < P and 0 <= yi < P:
                    want[i, yi, xi] += w * cw
    want = want.reshape(K, P * P)
    want = want - want.mean(1, keepdims=True)
    n = np.linalg.norm(want, axis=1, keepdims=True)
    want = want / np.maximum(n, 1e-6)

    got = np.asarray(F.constellation_descriptors(
        jnp.asarray(xy), jnp.asarray(power), jnp.asarray(valid), fcfg
    ))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)

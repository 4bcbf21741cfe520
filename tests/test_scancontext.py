import dataclasses

import jax.numpy as jnp
import numpy as np

from navtech_radar_slam_tpu.config import ScanContextConfig
from navtech_radar_slam_tpu.ops import scancontext as sc


CFG = ScanContextConfig()


def random_cloud(rng, n=300, rmax=75.0):
    r = rng.uniform(5.0, rmax, size=n)
    th = rng.uniform(0, 2 * np.pi, size=n)
    xy = np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)
    return jnp.asarray(xy, jnp.float32)


def rotate(xy, phi):
    c, s = np.cos(phi), np.sin(phi)
    R = np.array([[c, -s], [s, c]], np.float32)
    return jnp.asarray(np.asarray(xy) @ R.T)


def desc_of(xy):
    K = xy.shape[0]
    return sc.make_scancontext(xy, jnp.zeros(K), jnp.ones(K, bool), CFG)


def test_descriptor_occupancy_semantics(rng):
    xy = random_cloud(rng)
    d = np.asarray(desc_of(xy))
    assert d.shape == (CFG.num_ring, CFG.num_sector)
    # radar features have z=0 -> occupied bins hold exactly lidar_height
    vals = np.unique(d)
    assert set(np.round(vals, 5)).issubset({0.0, np.float32(CFG.lidar_height)})


def test_descriptor_rotation_equivariance(rng):
    xy = random_cloud(rng)
    k = 7
    phi = k * 2 * np.pi / CFG.num_sector
    d0 = np.asarray(desc_of(xy))
    d1 = np.asarray(desc_of(rotate(xy, phi)))
    np.testing.assert_allclose(d1, np.roll(d0, k, axis=1), atol=1e-6)


def test_distance_recovers_rotation(rng):
    xy = random_cloud(rng)
    k = 49  # > num_sector/2 -> negative wrap
    phi = k * 2 * np.pi / CFG.num_sector
    d0 = desc_of(xy)
    d1 = desc_of(rotate(xy, phi))
    dist, shift = sc.sc_distance_all_shifts(d1, d0[None])
    assert float(dist[0]) < 1e-5
    yaw = float(sc.shift_to_yaw(shift[0], CFG))
    expected = phi - 2 * np.pi  # wrapped
    assert abs(yaw - expected) < 1e-5


def test_distance_inexact_rotation(rng):
    xy = random_cloud(rng, n=500)
    phi = 0.9  # not a sector multiple
    d0 = desc_of(xy)
    d1 = desc_of(rotate(xy, phi))
    dist, shift = sc.sc_distance_all_shifts(d1, d0[None])
    assert float(dist[0]) < 0.35
    yaw = float(sc.shift_to_yaw(shift[0], CFG))
    assert abs(yaw - phi) <= 2 * np.pi / CFG.num_sector + 1e-6


def test_distance_different_scenes_large(rng):
    a = desc_of(random_cloud(rng))
    b = desc_of(random_cloud(np.random.default_rng(42)))
    dist, _ = sc.sc_distance_all_shifts(a, b[None])
    assert float(dist[0]) > 0.45


def test_ring_key_rotation_invariant(rng):
    xy = random_cloud(rng)
    k0 = np.asarray(sc.ring_key(desc_of(xy)))
    k1 = np.asarray(sc.ring_key(desc_of(rotate(xy, 1.234))))
    # inexact rotation rebins a few points; keys stay close
    assert np.abs(k0 - k1).max() < 0.25
    np.testing.assert_allclose(
        np.asarray(sc.ring_key(desc_of(rotate(xy, 4 * 2 * np.pi / CFG.num_sector)))),
        k0,
        atol=1e-6,
    )


def _make_bank(descs, n_max=64):
    R, S = CFG.num_ring, CFG.num_sector
    bank = np.zeros((n_max, R, S), np.float32)
    for i, d in enumerate(descs):
        bank[i] = np.asarray(d)
    return jnp.asarray(bank)


def test_detect_loop_finds_revisit(rng):
    """Bank of distinct scenes + a revisit of scene 3 (rotated) at the end."""
    scenes = [random_cloud(np.random.default_rng(i), n=400) for i in range(40)]
    descs = [desc_of(s) for s in scenes]
    query = desc_of(rotate(scenes[3], 0.6))
    bank = _make_bank(descs)
    res = sc.detect_loop(query, bank, jnp.asarray(41), CFG)
    assert bool(res.found)
    assert int(res.idx) == 3
    assert abs(float(res.yaw) - 0.6) < 2 * np.pi / CFG.num_sector + 1e-6


def test_detect_loop_excludes_recent(rng):
    scenes = [random_cloud(np.random.default_rng(i), n=400) for i in range(20)]
    descs = [desc_of(s) for s in scenes]
    # query = scene 15 again, but 15 is within num_exclude_recent of 20
    query = descs[15]
    res = sc.detect_loop(query, _make_bank(descs), jnp.asarray(20), CFG)
    assert not bool(res.found) or int(res.idx) < 20 - CFG.num_exclude_recent


def test_ringkey_mode_agrees_with_full(rng):
    # tree_making_period=1: always-fresh bank, so the two-stage result must
    # agree with the exhaustive search (the staleness emulation is tested
    # separately below)
    cfg = dataclasses.replace(CFG, tree_making_period=1)
    scenes = [random_cloud(np.random.default_rng(100 + i), n=400) for i in range(40)]
    descs = [desc_of(s) for s in scenes]
    query = desc_of(rotate(scenes[5], -0.4))
    bank = _make_bank(descs)
    keys = jnp.stack([sc.ring_key(jnp.asarray(d)) for d in descs] +
                     [jnp.zeros(CFG.num_ring)] * (64 - 40))
    full = sc.detect_loop(query, bank, jnp.asarray(41), cfg)
    two_stage = sc.detect_loop_ringkey(query, bank, keys, jnp.asarray(41), cfg)
    assert bool(full.found) and bool(two_stage.found)
    assert int(full.idx) == int(two_stage.idx) == 5


def test_ringkey_tree_staleness_bound():
    """tree_making_period emulates the reference's KD-tree rebuild cadence
    (Scancontext.h:103, cpp:347-360): a keyframe inserted after the last
    rebuild is invisible to the ring-key search until the next rebuild."""
    cfg = dataclasses.replace(CFG, num_exclude_recent=2, tree_making_period=4,
                              num_candidates=3)
    scenes = [random_cloud(np.random.default_rng(400 + i), n=400)
              for i in range(10)]
    descs = [desc_of(s) for s in scenes]
    bank = _make_bank(descs, n_max=16)
    keys = jnp.stack([sc.ring_key(jnp.asarray(d)) for d in descs] +
                     [jnp.zeros(CFG.num_ring)] * 6)
    query = desc_of(rotate(scenes[3], 0.3))

    # first tree at num_valid = exclude+1 = 3 (searchable idx < 1), next
    # rebuild at 7 (idx < 5): at num_valid 6 keyframe 3 is still invisible
    res_stale = sc.detect_loop_ringkey(query, bank, keys, jnp.asarray(6), cfg)
    assert not bool(res_stale.found) or int(res_stale.idx) != 3
    res_fresh = sc.detect_loop_ringkey(query, bank, keys, jnp.asarray(7), cfg)
    assert bool(res_fresh.found) and int(res_fresh.idx) == 3
    # period 1 = always fresh: visible already at num_valid 6
    cfg1 = dataclasses.replace(cfg, tree_making_period=1)
    res1 = sc.detect_loop_ringkey(query, bank, keys, jnp.asarray(6), cfg1)
    assert bool(res1.found) and int(res1.idx) == 3


def test_search_ratio_restricts_shift_window():
    """search_ratio wires the reference's sector-key-aligned ±10% shift
    search (fastAlignUsingVkey + distanceBtnScanContext, cpp:93-148).

    Column scaling is invisible to the column-normalized cosine distance
    but steers the sector-key alignment, so a bank entry that matches at
    shift 10 with a sector key aligned at shift 52 exposes the window: the
    exhaustive search finds the match, the ratio-restricted search must
    not."""
    rng = np.random.default_rng(7)
    q = rng.uniform(0.1, 1.0, size=(CFG.num_ring, CFG.num_sector)).astype(np.float32)
    q[:, 5] *= 10.0                      # query's dominant sector-key column
    b = np.roll(q, 10, axis=1)           # true match at shift 50 (q rolled +50)
    b[:, 57] *= 10.0                     # drags vkey alignment to ~8

    full_d, full_s = sc.sc_distance_all_shifts(jnp.asarray(q), jnp.asarray(b)[None])
    assert float(full_d[0]) < 1e-5 and int(full_s[0]) == 50

    ratio_d, ratio_s = sc.sc_distance_ratio_shifts(
        jnp.asarray(q), jnp.asarray(b)[None], CFG
    )
    # restricted window (±3 around the vkey alignment) excludes shift 50
    assert int(ratio_s[0]) != 50
    assert float(ratio_d[0]) > float(full_d[0]) + 1e-3

    # and when the alignment is honest (no scaling), ratio == full
    b2 = np.roll(q, 10, axis=1)
    rd, rs = sc.sc_distance_ratio_shifts(jnp.asarray(q), jnp.asarray(b2)[None], CFG)
    assert float(rd[0]) < 1e-5 and int(rs[0]) == 50


def test_between_sessions(rng):
    scenes = [random_cloud(np.random.default_rng(200 + i), n=400) for i in range(10)]
    descs = [desc_of(s) for s in scenes]
    query = desc_of(rotate(scenes[8], 0.2))
    res = sc.detect_loop_between_sessions(query, _make_bank(descs, 16), jnp.asarray(10), CFG)
    assert bool(res.found) and int(res.idx) == 8


def test_empty_sector_columns_handled():
    """Descriptors with many empty sectors must not produce NaNs."""
    xy = jnp.asarray([[10.0, 0.0], [20.0, 0.1]], jnp.float32)
    d = sc.make_scancontext(xy, jnp.zeros(2), jnp.ones(2, bool), CFG)
    dist, _ = sc.sc_distance_all_shifts(d, d[None])
    assert np.isfinite(float(dist[0]))
    assert float(dist[0]) < 1e-6


def test_scmanager_api_parity(rng):
    """Reference-named SCManager API over the batched ops."""
    mgr = sc.ScanContextManager(CFG, capacity=64)
    clouds = [random_cloud(np.random.default_rng(300 + i), n=400) for i in range(35)]
    for c in clouds:
        mgr.makeAndSaveScancontextAndKeys(c)
    assert mgr.num == 35
    # newest is a rotated revisit of scene 2
    mgr.makeAndSaveScancontextAndKeys(rotate(clouds[2], 0.5))
    idx, yaw = mgr.detectLoopClosureID()
    assert idx == 2
    assert abs(yaw - 0.5) < 2 * np.pi / CFG.num_sector + 1e-6

    # between-session query with an externally built descriptor
    other = sc.ScanContextManager(CFG, capacity=16)
    for c in clouds[:8]:
        other.saveScancontextAndKeys(desc_of(c))
    q = desc_of(rotate(clouds[5], -0.3))
    idx2, yaw2 = other.detectLoopClosureIDBetweenSession(q)
    assert idx2 == 5

    mgr.setSCdistThres(0.0)  # impossible threshold -> no loops
    idx3, _ = mgr.detectLoopClosureID()
    assert idx3 == -1


def _dist_direct_sc(sc1, sc2):
    """distDirectSC (Scancontext.cpp:69-90) as the reference writes it: a
    loop over columns, skipping any column that is zero in either."""
    total, n_eff = 0.0, 0
    for col in range(sc1.shape[1]):
        a, b = sc1[:, col].astype(np.float64), sc2[:, col].astype(np.float64)
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0.0 or nb == 0.0:
            continue
        total += a @ b / (na * nb)
        n_eff += 1
    return 1.0 - total / n_eff if n_eff else 1.0


def test_shift_distance_matrix_matches_dist_direct_sc_loop(rng):
    """Every (bank row, shift) entry equals distDirectSC of the bank row
    against the query rolled by that shift, computed column by column; the
    vectorized float64 reference used on the chip agrees too."""
    from navtech_radar_slam_tpu.ops.reference import (
        sc_shift_distance_matrix_np,
    )

    bank = np.stack([desc_of(random_cloud(rng, n=60)) for _ in range(5)])
    bank[2, :, 10:20] = 0.0                      # empty sectors
    query = np.asarray(np.roll(bank[3], 5, axis=1))
    dist = np.asarray(sc.sc_shift_distance_matrix(jnp.asarray(query),
                                                  jnp.asarray(bank)))
    S = query.shape[1]
    loop = np.array([[_dist_direct_sc(np.roll(query, -z, axis=1), b)
                      for z in range(S)] for b in np.asarray(bank)])
    np.testing.assert_allclose(dist, loop, atol=1e-5)
    np.testing.assert_allclose(sc_shift_distance_matrix_np(query, bank),
                               loop, atol=1e-12)
    assert int(dist[3].argmin()) == 5 and dist[3].min() < 1e-5

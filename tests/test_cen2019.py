import jax
import jax.numpy as jnp
import numpy as np

from navtech_radar_slam_tpu.config import SlamConfig
from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.ops import cen2019


def test_run_peaks_basic():
    power = jnp.asarray([[0.1, 0.5, 0.9, 0.4, 0.0, 0.3, 0.7, 0.2]], jnp.float32)
    mask = jnp.asarray([[False, True, True, True, False, True, True, False]])
    peaks = np.asarray(cen2019.run_peaks(power, mask))
    # one peak per run, at the run max
    assert peaks[0].tolist() == [False, False, True, False, False, False, True, False]


def test_run_peaks_ties_take_first():
    power = jnp.asarray([[0.5, 0.5, 0.5]], jnp.float32)
    mask = jnp.ones((1, 3), bool)
    peaks = np.asarray(cen2019.run_peaks(power, mask))
    assert peaks.sum() == 1 and peaks[0, 0]


def test_run_peaks_empty_mask():
    power = jnp.zeros((4, 16), jnp.float32)
    mask = jnp.zeros((4, 16), bool)
    assert np.asarray(cen2019.run_peaks(power, mask)).sum() == 0


def _detection_stats(detector):
    cfg = SlamConfig()
    cfg = cfg.replace(features=cfg.features.replace(detector=detector)) if hasattr(
        cfg.features, "replace"
    ) else cfg
    import dataclasses

    fcfg = dataclasses.replace(cfg.features, detector=detector)
    sim = RadarSimulator(cfg.radar)
    pose = np.asarray([10.0, -5.0, 0.3])
    scan = jnp.asarray(sim.render(pose, noise_seed=7))

    extract = jax.jit(
        lambda p: cen2019.extract_features(p, fcfg, cfg.radar)
    )
    feats = extract(scan)
    valid = np.asarray(feats.valid)
    az = np.asarray(feats.azimuth_idx)[valid]
    rb = np.asarray(feats.range_bin)[valid]

    rng_m, bearing, refl = sim.visible_landmarks(pose)
    lm_az = bearing / (2 * np.pi) * cfg.radar.num_azimuths
    lm_rb = rng_m / cfg.radar.range_resolution

    # for each sufficiently strong landmark within the feature region, is
    # there a detected feature nearby?
    strong = (refl > 0.5) & (lm_rb > cfg.features.min_range_bins + 10) & (lm_rb < 2800)
    hits = 0
    for a, r in zip(lm_az[strong], lm_rb[strong]):
        da = np.minimum(np.abs(az - a), cfg.radar.num_azimuths - np.abs(az - a))
        dr = np.abs(rb - r)
        if np.any((da < 3) & (dr < 6)):
            hits += 1
    recall = hits / max(strong.sum(), 1)

    # precision: fraction of detections near any landmark
    near = 0
    for a, r in zip(az, rb):
        da = np.minimum(np.abs(lm_az - a), cfg.radar.num_azimuths - np.abs(lm_az - a))
        dr = np.abs(lm_rb - r)
        if np.any((da < 4) & (dr < 8)):
            near += 1
    precision = near / max(len(az), 1)
    return recall, precision, valid.sum()


def test_cen2019_detects_landmarks():
    recall, precision, n = _detection_stats("cen2019")
    assert n > 50, f"too few features: {n}"
    assert recall > 0.85, f"recall {recall}"
    assert precision > 0.6, f"precision {precision}"


def test_cen2018_detects_landmarks():
    recall, precision, n = _detection_stats("cen2018")
    assert n > 30, f"too few features: {n}"
    assert recall > 0.6, f"recall {recall}"
    assert precision > 0.6, f"precision {precision}"


def test_features_to_xy():
    cfg = SlamConfig()
    from navtech_radar_slam_tpu.ops.cen2019 import FeatureSet, features_to_xy

    feats = FeatureSet(
        azimuth_idx=jnp.asarray([0, 100], jnp.int32),
        range_bin=jnp.asarray([100, 1000], jnp.int32),
        power=jnp.ones(2),
        valid=jnp.ones(2, bool),
    )
    az = (jnp.arange(cfg.radar.num_azimuths) + 0.5) / cfg.radar.num_azimuths * 2 * jnp.pi
    xy = np.asarray(features_to_xy(feats, az, cfg.radar))
    r0 = 100.5 * cfg.radar.range_resolution
    assert np.isclose(np.linalg.norm(xy[0]), r0, atol=1e-3)
    assert np.isclose(np.linalg.norm(xy[1]), 1000.5 * cfg.radar.range_resolution, atol=1e-2)


def test_feature_count_distribution_and_stability():
    """FIDELITY.md calibration pins, measured at an uncapped budget (4096)
    so the detector's OWN output is visible behind the max_features cap:

    (a) gated (default) per-scan counts sit in a stable band (~2800 on the
        simulator circuit) — so the default 1024 cap selects the strongest
        ~third (divergence #3, active by design);
    (b) the noise gate (divergence #2) only REMOVES peaks — the paper-pure
        mask (peak_zq=0) floods with noise-floor runs (saturates even 4096),
        which is the empirical justification for the gate;
    (c) counts are stable under the speckle seed."""
    import dataclasses

    cfg = SlamConfig()
    fcfg = dataclasses.replace(cfg.features, max_features=4096)
    fcfg_pure = dataclasses.replace(fcfg, peak_zq=0.0)
    sim = RadarSimulator(cfg.radar)
    gt = sim.circuit_trajectory(10, radius=10.0, speed=6.0)

    extract = jax.jit(lambda p: cen2019.extract_features(p, fcfg, cfg.radar))
    extract_pure = jax.jit(
        lambda p: cen2019.extract_features(p, fcfg_pure, cfg.radar)
    )

    counts, counts_pure = [], []
    for i in range(10):
        scan = jnp.asarray(sim.render(gt[i], noise_seed=i))
        counts.append(int(np.asarray(extract(scan).valid).sum()))
        counts_pure.append(int(np.asarray(extract_pure(scan).valid).sum()))

    counts = np.asarray(counts)
    # (a) stable band, cap not binding at 4096 (the detector's true count)
    assert (counts > 500).all() and (counts < fcfg.max_features).all(), counts
    assert counts.std() / counts.mean() < 0.2, counts

    # (b) gate removes, never adds
    for c, cp in zip(counts, counts_pure):
        assert cp >= c, (c, cp)

    # (c) seed stability: same pose re-rendered with different speckle
    base = [int(np.asarray(extract(
        jnp.asarray(sim.render(gt[3], noise_seed=100 + s))).valid).sum())
        for s in range(4)]
    base = np.asarray(base)
    assert base.max() - base.min() < 0.2 * base.mean(), base


def test_finalize_topk_is_exact_sort():
    """Peak selection is the exact global top-k: the strongest k peaks in
    descending power, ties to the lower flat index (np.argsort, stable)."""
    rng = np.random.default_rng(5)
    power = np.round(rng.random((40, 128)), 2).astype(np.float32)  # many ties
    peaks = rng.random((40, 128)) < 0.3
    k = 64
    fs = jax.device_get(cen2019._finalize_topk(jnp.asarray(power),
                                               jnp.asarray(peaks), k))
    scores = np.where(peaks, power, -np.inf).reshape(-1)
    order = np.argsort(-scores, kind="stable")[:k]
    assert fs.valid.all()
    np.testing.assert_array_equal(fs.azimuth_idx * 128 + fs.range_bin, order)
    np.testing.assert_array_equal(fs.power, scores[order])


def test_cen2019_matches_float64_reference():
    """The jitted detector on a full-width rendered scan against the
    float64 NumPy restatement (ops/reference.py): identical peak sets up
    to float-order ties (<= 1 %), powers to f32 rounding."""
    from navtech_radar_slam_tpu.ops.reference import cen2019_features_np

    cfg = SlamConfig()
    scan = RadarSimulator(cfg.radar).render(np.asarray([5.0, -3.0, 0.7]),
                                            noise_seed=3)
    fs = jax.device_get(cen2019.cen2019_features(jnp.asarray(scan),
                                                 cfg.features, cfg.radar))
    az, rb, pw = cen2019_features_np(scan, cfg.features, cfg.radar)
    v = fs.valid
    dev = set(zip(fs.azimuth_idx[v].tolist(), fs.range_bin[v].tolist()))
    ref = set(zip(az.tolist(), rb.tolist()))
    assert len(dev) == len(ref) > 100
    assert len(dev ^ ref) <= 0.01 * len(ref)
    np.testing.assert_allclose(np.sort(fs.power[v]), np.sort(pw), atol=1e-5)

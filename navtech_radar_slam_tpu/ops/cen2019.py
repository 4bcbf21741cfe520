"""cen2019 / cen2018 radar feature extraction, vectorized over the scan.

The reference front-end (ORORA submodule, absent from the tree; SURVEY §1 L1
step 2) extracts sparse targets from the polar power image with the Cen &
Newman peak detectors (cen2019 named at /root/reference/README.md:29).  The
upstream C++ implementations are scalar per-azimuth loops over OpenCV mats;
here the whole scan is processed as one fused array program:

cen2019 (one target per high-intensity region):
  1. Gaussian-smooth power along range.
  2. g = |gradient along range| (azimuth-smoothed), normalized to [0, 1].
  3. h = s' * (1 - g) where s' = mean-subtracted, floored power — high power
     AND low gradient, i.e. region interiors rather than edges.
  4. mask = h > mean(h) over the valid region.
  5. One peak (max power) per contiguous masked run along each azimuth —
     computed with a *segmented associative scan* (run-reset running max),
     not a per-run loop, so the whole step is two `lax.associative_scan`s.
  6. Global top-K peaks by power -> fixed-size (K, ...) feature set + mask.

cen2018 (threshold detector): mask = s > mean_az + zq * std_az per azimuth,
then the same segmented run-peak machinery.

Static shapes throughout: the output is always (max_features,) padded with
validity masks, so downstream matching/registration stays jit-compatible.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from navtech_radar_slam_tpu.config import FeatureConfig, RadarConfig
from navtech_radar_slam_tpu.ops.topk import top_k


class FeatureSet(NamedTuple):
    """K extracted features (padded to cfg.max_features)."""

    azimuth_idx: jnp.ndarray   # (K,) int32 row in the polar image
    range_bin: jnp.ndarray     # (K,) int32 column in the polar image
    power: jnp.ndarray         # (K,) float32 peak power
    valid: jnp.ndarray         # (K,) bool


def _gaussian_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _conv_along_range(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Depthwise 1-D convolution along the range (last) axis, same padding.

    Unrolled shift-and-add: a single-channel convolution has nothing for a
    matrix unit to do, while T shifted multiply-adds are one elementwise
    chain that XLA fuses into a single memory-bound pass."""
    taps = int(kernel.shape[0])
    r = taps // 2
    nb = img.shape[-1]
    padded = jnp.pad(img, [(0, 0)] * (img.ndim - 1) + [(r, r)])
    out = jnp.zeros_like(img)
    for t in range(taps):
        out = out + kernel[t] * jax.lax.slice_in_dim(
            padded, t, t + nb, axis=img.ndim - 1
        )
    return out


def _conv_along_azimuth_wrap(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """1-D convolution along azimuth (first) axis with circular wrap
    (same shift-and-add strategy as _conv_along_range)."""
    taps = int(kernel.shape[0])
    r = taps // 2
    na = img.shape[0]
    wrapped = jnp.concatenate([img[-r:], img, img[:r]], axis=0)
    out = jnp.zeros_like(img)
    for t in range(taps):
        out = out + kernel[t] * jax.lax.slice_in_dim(wrapped, t, t + na, axis=0)
    return out


def _segmented_running_max(v: jnp.ndarray, reset: jnp.ndarray, reverse: bool = False):
    """Inclusive running max along the last axis that restarts where
    ``reset`` is True (at position i the scan starts fresh from v[i]).

    Implemented with `lax.associative_scan` over the standard segmented-max
    monoid: (m2, r2) ∘ (m1, r1) applied left-to-right gives
    m = m2 if r2 else max(m1, m2).
    """

    def combine(a, b):
        m1, r1 = a
        m2, r2 = b
        m = jnp.where(r2, m2, jnp.maximum(m1, m2))
        return m, jnp.logical_or(r1, r2)

    m, _ = jax.lax.associative_scan(
        combine, (v, reset), axis=v.ndim - 1, reverse=reverse
    )
    return m


def run_peaks(power: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """One peak per contiguous True-run of ``mask`` along the last axis.

    Returns a bool array marking, for each run, the first position that
    attains the run's max ``power``.  Fully vectorized (two segmented scans).
    """
    neg = jnp.float32(-jnp.inf)
    v = jnp.where(mask, power, neg)
    prev_mask = jnp.pad(mask[..., :-1], [(0, 0)] * (mask.ndim - 1) + [(1, 0)])
    run_start = mask & ~prev_mask
    reset_fwd = run_start | ~mask

    m_fwd_incl = _segmented_running_max(v, reset_fwd)

    next_mask = jnp.pad(mask[..., 1:], [(0, 0)] * (mask.ndim - 1) + [(0, 1)])
    run_end = mask & ~next_mask
    reset_bwd = run_end | ~mask
    m_bwd_incl = _segmented_running_max(v, reset_bwd, reverse=True)

    run_max = jnp.maximum(m_fwd_incl, m_bwd_incl)
    # exclusive forward prefix max within the run
    m_fwd_excl = jnp.where(
        run_start | ~mask,
        neg,
        jnp.pad(m_fwd_incl[..., :-1], [(0, 0)] * (mask.ndim - 1) + [(1, 0)],
                constant_values=neg),
    )
    return mask & (v >= run_max) & (m_fwd_excl < v)


def _finalize_topk(power: jnp.ndarray, peaks: jnp.ndarray, k: int) -> FeatureSet:
    """The k strongest peaks by ``power`` (exact global top-k)."""
    nb = power.shape[1]
    scores = jnp.where(peaks, power, -jnp.inf).reshape(-1)
    top_scores, top_idx = top_k(scores, k)
    valid = jnp.isfinite(top_scores)
    az = (top_idx // nb).astype(jnp.int32)
    rb = (top_idx % nb).astype(jnp.int32)
    return FeatureSet(
        azimuth_idx=jnp.where(valid, az, 0),
        range_bin=jnp.where(valid, rb, 0),
        power=jnp.where(valid, top_scores, 0.0),
        valid=valid,
    )


def _valid_region_mask(shape, min_bin: int, num_range_bins: int) -> jnp.ndarray:
    na, nb = shape
    col = jax.lax.broadcasted_iota(jnp.int32, (na, nb), 1)
    return (col >= min_bin) & (col < num_range_bins)


def cen2019_features(
    power: jnp.ndarray, fcfg: FeatureConfig, rcfg: RadarConfig
) -> FeatureSet:
    """Extract up to ``fcfg.max_features`` targets from one polar scan.

    power: (num_azimuths, padded_range_bins) float32 in [0, 1].
    """
    region = _valid_region_mask(power.shape, fcfg.min_range_bins, rcfg.num_range_bins)
    s = jnp.where(region, power, 0.0)

    radius = max(1, int(3 * fcfg.smooth_sigma_bins))
    s_smooth = _conv_along_range(s, _gaussian_kernel1d(fcfg.smooth_sigma_bins, radius))

    # gradient along range, smoothed across azimuth (prewitt-style)
    grad = _conv_along_range(s_smooth, jnp.asarray([0.5, 0.0, -0.5], jnp.float32))
    grad = _conv_along_azimuth_wrap(
        jnp.abs(grad), jnp.asarray([0.25, 0.5, 0.25], jnp.float32)
    )
    g = grad / jnp.maximum(jnp.max(grad), 1e-9)

    # mean-subtracted power (positive part): suppress the noise floor
    denom = jnp.maximum(jnp.sum(region, axis=1, keepdims=True), 1).astype(jnp.float32)
    az_mean = jnp.sum(s_smooth * region, axis=1, keepdims=True) / denom
    sp = jnp.maximum(s_smooth - az_mean, 0.0)

    h = sp * (1.0 - g)
    h_mean = jnp.sum(h * region) / jnp.maximum(jnp.sum(region), 1)
    mask = (h > h_mean) & region
    if fcfg.peak_zq > 0:
        # per-azimuth noise gate (implementation addition over the paper's
        # pure h > mean(h) statistic — see FIDELITY.md): a region must also
        # rise above its azimuth's noise statistics; peak_zq <= 0 disables
        az_var = jnp.sum(
            jnp.square(s_smooth - az_mean) * region, axis=1, keepdims=True
        ) / denom
        noise_gate = az_mean + fcfg.peak_zq * jnp.sqrt(az_var)
        mask = mask & (s_smooth > noise_gate)

    peaks = run_peaks(s_smooth, mask)
    # rank and report peaks by *smoothed* power: single-bin speckle spikes
    # collapse under the range smoothing while true blobs survive, so the
    # top-k ordering (and any downstream power weighting) is noise-robust
    return _finalize_topk(s_smooth, peaks, fcfg.max_features)


def cen2018_features(
    power: jnp.ndarray, fcfg: FeatureConfig, rcfg: RadarConfig
) -> FeatureSet:
    """Threshold detector: per-azimuth mean + zq * std gate, then run peaks."""
    region = _valid_region_mask(power.shape, fcfg.min_range_bins, rcfg.num_range_bins)
    s = jnp.where(region, power, 0.0)
    radius = max(1, int(3 * fcfg.smooth_sigma_bins))
    s_smooth = _conv_along_range(s, _gaussian_kernel1d(fcfg.smooth_sigma_bins, radius))

    denom = jnp.maximum(jnp.sum(region, axis=1, keepdims=True), 1).astype(jnp.float32)
    mean = jnp.sum(s_smooth * region, axis=1, keepdims=True) / denom
    var = jnp.sum(jnp.square(s_smooth - mean) * region, axis=1, keepdims=True) / denom
    thresh = mean + fcfg.cen2018_zq * jnp.sqrt(var)
    mask = (s_smooth > thresh) & region

    peaks = run_peaks(s_smooth, mask)
    return _finalize_topk(s_smooth, peaks, fcfg.max_features)


def extract_features(
    power: jnp.ndarray, fcfg: FeatureConfig, rcfg: RadarConfig
) -> FeatureSet:
    if fcfg.detector == "cen2019":
        return cen2019_features(power, fcfg, rcfg)
    if fcfg.detector == "cen2018":
        return cen2018_features(power, fcfg, rcfg)
    raise ValueError(f"unknown detector {fcfg.detector!r}")


def features_to_xy(
    feats: FeatureSet, azimuths: jnp.ndarray, rcfg: RadarConfig
) -> jnp.ndarray:
    """Polar feature indices -> Cartesian sensor-frame xy (K, 2), meters.

    ``azimuths``: (num_azimuths,) ray angles (rad) from the scan metadata —
    the encoder values the MulRan format embeds per ray (data/mulran.py)."""
    theta = azimuths[feats.azimuth_idx]
    r = (feats.range_bin.astype(jnp.float32) + 0.5) * rcfg.range_resolution
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)

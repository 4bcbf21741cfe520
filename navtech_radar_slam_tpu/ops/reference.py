"""Plain float64 NumPy references for the device hot paths.

Each function restates, independently of the jitted code, what one device
op computes: the cen2019 detector (ops/cen2019.py), the ScanContext
all-shift distance matrix (ops/scancontext.py, distDirectSC of
Scancontext.cpp:69-90) and brute-force nearest neighbours (ops/icp.py).
Tests compare the device ops with them on the CPU, and chip_smoke.py on
the accelerator at full width.  They favour clarity over speed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from navtech_radar_slam_tpu.config import FeatureConfig, RadarConfig


def _correlate_along_range(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """out[:, i] = sum_t taps[t] * img[:, i + t - r], zero outside."""
    r = len(taps) // 2
    nb = img.shape[1]
    padded = np.pad(img, ((0, 0), (r, r)))
    return sum(w * padded[:, t:t + nb] for t, w in enumerate(taps))


def run_peaks_np(power: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """First position of the maximum of every contiguous True run of
    ``mask`` along each row."""
    peaks = np.zeros(mask.shape, bool)
    for a in range(mask.shape[0]):
        m = np.concatenate([[False], mask[a], [False]]).astype(np.int8)
        starts = np.flatnonzero(np.diff(m) == 1)
        ends = np.flatnonzero(np.diff(m) == -1)
        for s, e in zip(starts, ends):
            peaks[a, s + int(np.argmax(power[a, s:e]))] = True
    return peaks


def cen2019_features_np(power: np.ndarray, fcfg: FeatureConfig,
                        rcfg: RadarConfig):
    """cen2019 peaks of one polar scan, strongest first.

    Returns (azimuth_idx, range_bin, power) of up to fcfg.max_features
    peaks, ranked by smoothed power with ties to the lower flat index."""
    p = np.asarray(power, np.float64)
    na, nb = p.shape
    col = np.arange(nb)[None, :]
    region = np.broadcast_to(
        (col >= fcfg.min_range_bins) & (col < rcfg.num_range_bins), p.shape)
    s = np.where(region, p, 0.0)

    sigma = fcfg.smooth_sigma_bins
    radius = max(1, int(3 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    gauss = np.exp(-0.5 * (x / sigma) ** 2)
    s_smooth = _correlate_along_range(s, gauss / gauss.sum())

    grad = np.abs(_correlate_along_range(s_smooth, np.array([0.5, 0.0, -0.5])))
    grad = (0.25 * np.roll(grad, 1, axis=0) + 0.5 * grad
            + 0.25 * np.roll(grad, -1, axis=0))
    g = grad / max(grad.max(), 1e-9)

    denom = np.maximum(region.sum(axis=1, keepdims=True), 1)
    az_mean = (s_smooth * region).sum(axis=1, keepdims=True) / denom
    h = np.maximum(s_smooth - az_mean, 0.0) * (1.0 - g)
    h_mean = (h * region).sum() / max(region.sum(), 1)
    mask = (h > h_mean) & region
    if fcfg.peak_zq > 0:
        az_var = ((s_smooth - az_mean) ** 2 * region).sum(
            axis=1, keepdims=True) / denom
        mask &= s_smooth > az_mean + fcfg.peak_zq * np.sqrt(az_var)

    peaks = run_peaks_np(s_smooth, mask)
    flat = np.flatnonzero(peaks.reshape(-1))
    vals = s_smooth.reshape(-1)[flat]
    order = np.lexsort((flat, -vals))[: fcfg.max_features]
    top = flat[order]
    return top // nb, top % nb, vals[order]


def sc_shift_distance_matrix_np(query: np.ndarray,
                                bank: np.ndarray) -> np.ndarray:
    """(R, S) query vs (N, R, S) bank -> (N, S) distDirectSC per shift.

    Entry [n, z] compares bank[n] with the query rolled so that its column
    (z + c) mod S meets bank column c: the mean over columns non-zero in
    both of (1 - cosine similarity), or 1.0 when no such column exists."""
    q = np.asarray(query, np.float64)
    b = np.asarray(bank, np.float64)
    S = q.shape[1]
    b_norm = np.linalg.norm(b, axis=1)                       # (N, S)
    out = np.empty((b.shape[0], S))
    for z in range(S):
        qz = np.roll(q, -z, axis=1)
        q_norm = np.linalg.norm(qz, axis=0)                  # (S,)
        both = (q_norm > 1e-9)[None, :] & (b_norm > 1e-9)
        cos = np.einsum("rc,nrc->nc", qz, b) / np.maximum(
            q_norm[None, :] * b_norm, 1e-18)
        n_eff = both.sum(axis=1)
        sim = np.where(both, cos, 0.0).sum(axis=1)
        out[:, z] = np.where(n_eff > 0, 1.0 - sim / np.maximum(n_eff, 1), 1.0)
    return out


def nearest_neighbors_np(src: np.ndarray, tgt: np.ndarray,
                         tgt_valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force NN in float64: (squared distance (Nq,), index (Nq,)),
    +inf where no target is valid; ties go to the lowest index."""
    d = (np.asarray(src, np.float64)[:, None, :]
         - np.asarray(tgt, np.float64)[None, :, :])
    d2 = np.where(np.asarray(tgt_valid)[None, :], (d * d).sum(-1), np.inf)
    idx = np.argmin(d2, axis=1)
    return d2[np.arange(len(idx)), idx], idx

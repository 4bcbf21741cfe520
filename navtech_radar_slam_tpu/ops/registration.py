"""ORORA-style outlier-robust SE(2) scan registration on the accelerator.

Re-implements the capability of the reference's odometry front-end
(ORORA, arXiv:2303.01876 — submodule absent from the tree; behavior spec in
SURVEY §1 L1 step 4): given matched radar feature pairs contaminated by
outliers, estimate the relative SE(2) motion with

  1. **anisotropic measurement uncertainty** — a radar target's noise is
     small along range (sigma_r) and grows tangentially with range
     (r * sigma_theta);
  2. **pairwise-consistency pruning** — translation-invariant measurements
     (TIMs) must preserve pairwise distances; instead of the reference's
     max-clique search we use *spectral matching* (power iteration on the
     consistency matrix — pure matmuls, no graph code);
  3. **decoupled estimation** — rotation first via GNC-TLS (graduated
     non-convexity over a truncated-least-squares cost, fixed-iteration
     `lax.scan`), then translation via component-wise robust IRLS
     (the paper's COTE-style decoupling) conditioned on the rotation.

Everything is statically shaped: M correspondences padded with validity
masks; the GNC mu-schedule runs a fixed number of iterations with masked
updates rather than data-dependent convergence breaks (XLA-friendly).

Convention: for a world point X seen as `a` in the previous scan frame and
`b` in the current scan frame, the estimated (R, t) satisfy  b ≈ R a + t.
The odometry increment (gtsam `between(prev, curr)` semantics the back-end
consumes, laserPosegraphOptimization.cpp:514-524) is then
T_rel = (R^T, -R^T t), returned as [x, y, theta].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from navtech_radar_slam_tpu.config import RegistrationConfig
from navtech_radar_slam_tpu.ops.features import MatchSet
from navtech_radar_slam_tpu.ops.topk import top_k


class RegistrationResult(NamedTuple):
    rel_pose: jnp.ndarray      # (3,) odometry increment [x, y, theta]
    inlier_mask: jnp.ndarray   # (M,) bool final GNC inliers
    num_inliers: jnp.ndarray   # () int32
    mean_residual: jnp.ndarray  # () float32 mean inlier residual (m)
    ok: jnp.ndarray            # () bool — enough inliers to trust the result


def point_sigmas(ranges: jnp.ndarray, cfg: RegistrationConfig) -> jnp.ndarray:
    """Effective isotropic bound of the anisotropic noise: the tangential
    component r*sigma_theta dominates at range; keep the conservative
    envelope sqrt(sigma_r² + (r sigma_theta)²)."""
    tang = ranges * cfg.sigma_azimuth_rad
    return jnp.sqrt(cfg.sigma_range**2 + tang * tang)


def spectral_inlier_scores(
    matches: MatchSet, cfg: RegistrationConfig
) -> jnp.ndarray:
    """Leading-eigenvector scores of the pairwise-consistency graph.

    A_ij = 1 iff | ||a_i - a_j|| - ||b_i - b_j|| | <= gate_ij, the classic
    TIM compatibility test (TEASER/ORORA pruning stage).  The principal
    eigenvector of A concentrates mass on the largest consistent cluster =
    the inlier set; power iteration is M×M matmuls, at the default
    precision (TF32 on the GPU): only the ranking of the scores is used."""
    a, b = matches.src_xy, matches.dst_xy
    va = matches.valid

    da = jnp.linalg.norm(a[:, None, :] - a[None, :, :], axis=-1)
    db = jnp.linalg.norm(b[:, None, :] - b[None, :, :], axis=-1)
    sig = point_sigmas(jnp.maximum(matches.src_range, matches.dst_range), cfg)
    gate = cfg.consistency_gate + (sig[:, None] + sig[None, :])
    pairmask = va[:, None] & va[None, :]
    A = (jnp.abs(da - db) <= gate) & pairmask
    A = A & ~jnp.eye(A.shape[0], dtype=bool)
    Af = A.astype(jnp.float32)

    def body(v, _):
        v = Af @ v
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-9)
        return v, None

    v0 = jnp.where(va, 1.0, 0.0)
    v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-9)
    v, _ = jax.lax.scan(body, v0, None, length=cfg.spectral_iters)
    return jnp.where(va, jnp.abs(v), 0.0)


def _gnc_tls_weights(res2: jnp.ndarray, mu: jnp.ndarray, barc2: float) -> jnp.ndarray:
    """Closed-form GNC-TLS weight update (Yang et al. GNC, used by ORORA)."""
    upper = (mu + 1.0) / mu * barc2
    lower = mu / (mu + 1.0) * barc2
    w = jnp.sqrt(barc2 * mu * (mu + 1.0) / jnp.maximum(res2, 1e-12)) - mu
    w = jnp.clip(w, 0.0, 1.0)
    w = jnp.where(res2 >= upper, 0.0, w)
    w = jnp.where(res2 <= lower, 1.0, w)
    return w


def gnc_rotation(
    tim_a: jnp.ndarray,
    tim_b: jnp.ndarray,
    tim_sigma: jnp.ndarray,
    tim_valid: jnp.ndarray,
    cfg: RegistrationConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """GNC-TLS rotation over TIMs: find theta minimizing the truncated sum of
    || R(theta) â_k - b̂_k ||² / sigma_k².

    Closed-form inner step: theta = atan2(Σ w (â × b̂), Σ w (â · b̂)).
    Returns (theta, final_weights)."""
    cross = tim_a[:, 0] * tim_b[:, 1] - tim_a[:, 1] * tim_b[:, 0]
    dot = jnp.sum(tim_a * tim_b, axis=-1)
    inv_var = jnp.where(tim_valid, 1.0 / jnp.maximum(tim_sigma**2, 1e-9), 0.0)

    def residual2(theta):
        c, s = jnp.cos(theta), jnp.sin(theta)
        Ra = jnp.stack(
            [c * tim_a[:, 0] - s * tim_a[:, 1], s * tim_a[:, 0] + c * tim_a[:, 1]],
            axis=-1,
        )
        return jnp.sum((Ra - tim_b) ** 2, axis=-1) * inv_var

    def solve(w):
        wv = w * inv_var
        return jnp.arctan2(jnp.sum(wv * cross), jnp.maximum(jnp.sum(wv * dot), -jnp.inf))

    w0 = tim_valid.astype(jnp.float32)
    theta0 = solve(w0)
    r2_max = jnp.max(jnp.where(tim_valid, residual2(theta0), 0.0))
    mu0 = cfg.gnc_barc2 / jnp.maximum(2.0 * r2_max - cfg.gnc_barc2, 1e-6)
    mu0 = jnp.maximum(mu0, 1e-6)

    def body(carry, _):
        theta, mu = carry
        w = _gnc_tls_weights(residual2(theta), mu, cfg.gnc_barc2) * tim_valid
        theta = solve(w)
        mu = mu * cfg.gnc_div_factor
        return (theta, mu), w

    (theta, _), ws = jax.lax.scan(
        body, (theta0, mu0), None, length=cfg.gnc_max_iters
    )
    return theta, ws[-1]


def robust_translation(
    a: jnp.ndarray,
    b: jnp.ndarray,
    sigma: jnp.ndarray,
    valid: jnp.ndarray,
    theta: jnp.ndarray,
    cfg: RegistrationConfig,
) -> jnp.ndarray:
    """Decoupled component-wise robust translation (COTE-style):
    candidates t_i = b_i - R a_i; per-component weighted median seed, then
    IRLS with TLS-style truncation at the anisotropic noise scale."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    Ra = jnp.stack([c * a[:, 0] - s * a[:, 1], s * a[:, 0] + c * a[:, 1]], axis=-1)
    cand = b - Ra                                     # (M, 2)
    w_meas = jnp.where(valid, 1.0 / jnp.maximum(sigma, 1e-6), 0.0)

    def weighted_median(vals, w):
        order = jnp.argsort(vals)
        vs = vals[order]
        ws = w[order]
        cw = jnp.cumsum(ws)
        total = jnp.maximum(cw[-1], 1e-9)
        idx = jnp.searchsorted(cw, 0.5 * total)
        return vs[jnp.clip(idx, 0, vals.shape[0] - 1)]

    t0 = jnp.stack(
        [weighted_median(cand[:, 0], w_meas), weighted_median(cand[:, 1], w_meas)]
    )

    def body(t, _):
        r = (cand - t[None, :]) / jnp.maximum(sigma[:, None], 1e-6)
        w = 1.0 / (1.0 + jnp.sum(r * r, axis=-1))          # Cauchy IRLS
        w = w * valid
        t = jnp.sum(w[:, None] * cand, axis=0) / jnp.maximum(jnp.sum(w), 1e-9)
        return t, None

    t, _ = jax.lax.scan(body, t0, None, length=cfg.cote_iters)
    return t


def _solve3x3(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 solve (adjugate/Cramer). Avoids the general LU path,
    a poor fit for tiny systems inside scans."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f = H[1, 0], H[1, 1], H[1, 2]
    h, i, j = H[2, 0], H[2, 1], H[2, 2]
    A = e * j - f * i
    B = -(d * j - f * h)
    C = d * i - e * h
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.array(
        [
            [A, -(b * j - c * i), b * f - c * e],
            [B, a * j - c * h, -(a * f - c * d)],
            [C, -(a * i - b * h), a * e - b * d],
        ]
    )
    return adj @ g / det


def point_information(xy: jnp.ndarray, cfg: RegistrationConfig) -> jnp.ndarray:
    """Per-point 2x2 inverse covariance W = R(phi) diag(1/sr², 1/st²) R(phi)^T
    where phi is the point's bearing, sr the range sigma, st = r*sigma_theta
    the tangential sigma — the anisotropic radar noise model at the heart of
    ORORA (paper §III; the reason scalar-weighted estimators drift at range)."""
    r = jnp.linalg.norm(xy, axis=-1)
    phi = jnp.arctan2(xy[..., 1], xy[..., 0])
    c, s = jnp.cos(phi), jnp.sin(phi)
    ir2 = 1.0 / jnp.maximum(cfg.sigma_range**2, 1e-12)
    it2 = 1.0 / jnp.maximum((jnp.maximum(r, 1.0) * cfg.sigma_azimuth_rad) ** 2, 1e-12)
    # W = [[c,-s],[s,c]] @ diag(ir2, it2) @ [[c,s],[-s,c]]
    w00 = c * c * ir2 + s * s * it2
    w01 = c * s * (ir2 - it2)
    w11 = s * s * ir2 + c * c * it2
    return jnp.stack(
        [jnp.stack([w00, w01], axis=-1), jnp.stack([w01, w11], axis=-1)], axis=-2
    )


def anisotropic_refine(
    a: jnp.ndarray,
    b: jnp.ndarray,
    valid: jnp.ndarray,
    theta0: jnp.ndarray,
    t0: jnp.ndarray,
    cfg: RegistrationConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Joint (theta, t) Gauss-Newton over inliers with per-point anisotropic
    information matrices and Cauchy robustness.  Residual e_i = R a_i + t - b_i,
    Jacobian [I2 | dR/dtheta a_i]; 3x3 normal equations solved in closed form."""
    W = point_information(b, cfg) * valid[:, None, None].astype(jnp.float32)

    def body(carry, _):
        theta, t = carry
        c, s = jnp.cos(theta), jnp.sin(theta)
        Ra = jnp.stack([c * a[:, 0] - s * a[:, 1], s * a[:, 0] + c * a[:, 1]], axis=-1)
        e = Ra + t[None, :] - b                                   # (M, 2)
        dRa = jnp.stack(
            [-s * a[:, 0] - c * a[:, 1], c * a[:, 0] - s * a[:, 1]], axis=-1
        )
        J = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(2), (a.shape[0], 2, 2)), dRa[:, :, None]],
            axis=2,
        )                                                          # (M, 2, 3)
        # Cauchy robust scaling on the Mahalanobis residual.  HIGHEST
        # precision: these einsums contract metric coordinates (|a| up to
        # 80 m); the GPU's default TF32 keeps ~3 decimal digits, which
        # would bias the normal equations by ~0.1 % — cm-scale odometry
        # error per frame.
        hi = jax.lax.Precision.HIGHEST
        r2 = jnp.einsum("mi,mij,mj->m", e, W, e, precision=hi)
        rw = 1.0 / (1.0 + r2)
        Wr = W * rw[:, None, None]
        H = jnp.einsum("mji,mjk,mkl->il", J, Wr, J, precision=hi) + 1e-6 * jnp.eye(3)
        g = jnp.einsum("mji,mjk,mk->i", J, Wr, e, precision=hi)
        delta = _solve3x3(H, -g)
        return (theta + delta[2], t + delta[:2]), None

    (theta, t), _ = jax.lax.scan(body, (theta0, t0), None, length=cfg.refine_iters)
    return theta, t


def register_scans(matches: MatchSet, cfg: RegistrationConfig) -> RegistrationResult:
    """Full ORORA-style pipeline on a padded MatchSet."""
    M = matches.valid.shape[0]
    scores = spectral_inlier_scores(matches, cfg)
    k = min(cfg.spectral_top_k, M)
    top_scores, top_idx = top_k(scores, k)
    sel_valid = matches.valid[top_idx] & (top_scores > 1e-6)

    a = matches.src_xy[top_idx]
    b = matches.dst_xy[top_idx]
    sigma = point_sigmas(
        jnp.maximum(matches.src_range, matches.dst_range), cfg
    )[top_idx]

    # TIMs: differences of consecutive selected correspondences (ring), a
    # sparse O(k) generator set of the translation-invariant measurements
    roll = lambda x: jnp.roll(x, shift=-1, axis=0)
    tim_a = a - roll(a)
    tim_b = b - roll(b)
    tim_sigma = jnp.sqrt(sigma**2 + roll(sigma) ** 2)
    tim_valid = sel_valid & roll(sel_valid)
    # degenerate TIMs (nearly coincident points) carry no rotation signal
    tim_len = jnp.linalg.norm(tim_a, axis=-1)
    tim_valid = tim_valid & (tim_len > 4.0 * tim_sigma)

    theta, _ = gnc_rotation(tim_a, tim_b, tim_sigma, tim_valid, cfg)
    t = robust_translation(a, b, sigma, sel_valid, theta, cfg)

    # GNC/COTE give a robust but scalar-weighted seed; polish jointly with
    # the full anisotropic noise model over the (soft) inlier set
    c, s = jnp.cos(theta), jnp.sin(theta)
    Ra0 = jnp.stack([c * a[:, 0] - s * a[:, 1], s * a[:, 0] + c * a[:, 1]], axis=-1)
    res0 = jnp.linalg.norm(Ra0 + t[None, :] - b, axis=-1)
    seed_inl = sel_valid & (res0 < 5.0 * jnp.maximum(sigma, cfg.sigma_range))
    theta, t = anisotropic_refine(a, b, seed_inl, theta, t, cfg)

    # final inlier classification at the measurement level
    c, s = jnp.cos(theta), jnp.sin(theta)
    Ra = jnp.stack([c * a[:, 0] - s * a[:, 1], s * a[:, 0] + c * a[:, 1]], axis=-1)
    res = jnp.linalg.norm(Ra + t[None, :] - b, axis=-1)
    inl = sel_valid & (res < 3.0 * jnp.maximum(sigma, cfg.sigma_range))
    n_inl = jnp.sum(inl)
    mean_res = jnp.sum(jnp.where(inl, res, 0.0)) / jnp.maximum(n_inl, 1)

    # b = R a + t  =>  T_rel = (R^T, -R^T t), theta_rel = -theta
    xr = -(c * t[0] + s * t[1])
    yr = -(-s * t[0] + c * t[1])
    rel = jnp.stack([xr, yr, -theta])

    inlier_mask = jnp.zeros((M,), bool).at[top_idx].set(inl)
    return RegistrationResult(
        rel_pose=rel,
        inlier_mask=inlier_mask,
        num_inliers=n_inl.astype(jnp.int32),
        mean_residual=mean_res,
        ok=n_inl >= cfg.min_inliers,
    )

"""SE(2)/SO(3)/SE(3) Lie-group math, batch-friendly, jnp.

The reference keeps poses as gtsam::Pose3 built from RPY Euler angles
(laserPosegraphOptimization.cpp:175-197, common.h:55-62).  Here poses are
plain arrays so every SLAM stage stays a pure, jittable function:

  * SE(2) pose  : shape (..., 3)   = [x, y, theta]          (odometry front-end)
  * SE(3) pose  : shape (..., 4, 4) homogeneous matrix       (pose graph, map)
  * SE(3) tangent: shape (..., 6)  = [rho(3), phi(3)]        (GN updates)

All functions broadcast over leading dims and are safe under jit/vmap/grad.
Small-angle branches use Taylor guards rather than data-dependent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax as _lax

_EPS = 1e-8

#: Matmul precision for POSE math.  At the default precision a GPU runs
#: f32 matmuls in TF32 (10-bit mantissa); at |t| ~ 100 m that injects
#: ~0.05-0.1 m of error into a single 4x4 pose composition — fatal for the
#: pose graph, whose odometry residuals are whitened by 1/sigma = 100-1000
#: (a rounded odometry chain no longer sits at its own exact solution, and
#: warm-started GN random-walks away from it).  Pose matrices are tiny —
#: full-f32 passes cost nothing — so every metric-coordinate matmul in this
#: module pins HIGHEST; only large *normalized-score* matmuls (descriptor
#: splat, ScanContext search) keep the default.
_HI = _lax.Precision.HIGHEST


def _mm(a, b):
    """Matmul at full f32 precision (pose-composition safe on any backend)."""
    return jnp.matmul(a, b, precision=_HI)


# ---------------------------------------------------------------------------
# SE(2)
# ---------------------------------------------------------------------------

def se2_identity(dtype=jnp.float32):
    return jnp.zeros((3,), dtype=dtype)


def wrap_angle(theta):
    """Wrap angle(s) to (-pi, pi]."""
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


def se2_mul(a, b):
    """Compose SE(2) poses: a ∘ b (apply b in a's frame)."""
    xa, ya, ta = a[..., 0], a[..., 1], a[..., 2]
    xb, yb, tb = b[..., 0], b[..., 1], b[..., 2]
    c, s = jnp.cos(ta), jnp.sin(ta)
    x = xa + c * xb - s * yb
    y = ya + s * xb + c * yb
    t = wrap_angle(ta + tb)
    return jnp.stack([x, y, t], axis=-1)


def se2_inv(a):
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = jnp.cos(t), jnp.sin(t)
    xi = -(c * x + s * y)
    yi = -(-s * x + c * y)
    return jnp.stack([xi, yi, -t], axis=-1)


def se2_between(a, b):
    """Relative pose a^{-1} ∘ b (gtsam `between` semantics,
    laserPosegraphOptimization.cpp:523)."""
    return se2_mul(se2_inv(a), b)


def se2_apply(a, pts):
    """Transform points (..., N, 2) by pose(s) (..., 3)."""
    c, s = jnp.cos(a[..., 2:3]), jnp.sin(a[..., 2:3])
    x = pts[..., 0]
    y = pts[..., 1]
    xn = c * x - s * y + a[..., 0:1]
    yn = s * x + c * y + a[..., 1:2]
    return jnp.stack([xn, yn], axis=-1)


def se2_to_se3(p):
    """Lift planar pose [x, y, theta] to a 4x4 SE(3) matrix (z=0, roll=pitch=0).

    Mirrors how the reference treats radar odometry as Pose3 with z≈0
    (SURVEY §3.5; laserPosegraphOptimization.cpp:175-187 odom->Pose6D)."""
    x, y, t = p[..., 0], p[..., 1], p[..., 2]
    c, s = jnp.cos(t), jnp.sin(t)
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows = [
        jnp.stack([c, -s, zero, x], axis=-1),
        jnp.stack([s, c, zero, y], axis=-1),
        jnp.stack([zero, zero, one, zero], axis=-1),
        jnp.stack([zero, zero, zero, one], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def se3_to_se2(T):
    """Project SE(3) matrix to [x, y, yaw]."""
    x = T[..., 0, 3]
    y = T[..., 1, 3]
    yaw = jnp.arctan2(T[..., 1, 0], T[..., 0, 0])
    return jnp.stack([x, y, yaw], axis=-1)


# ---------------------------------------------------------------------------
# SE(2), host-side numpy variants
#
# Every *eager* jnp op is a device dispatch and, to read it, a transfer;
# the streaming SLAM host loop therefore does its tiny per-scan pose
# bookkeeping in numpy and reserves jnp for jitted programs.
# ---------------------------------------------------------------------------

def se2_mul_np(a: "np.ndarray", b: "np.ndarray") -> "np.ndarray":
    import numpy as np

    c, s = np.cos(a[2]), np.sin(a[2])
    t = a[2] + b[2]
    return np.asarray(
        [a[0] + c * b[0] - s * b[1],
         a[1] + s * b[0] + c * b[1],
         np.arctan2(np.sin(t), np.cos(t))], np.float64
    )


def se2_between_np(a: "np.ndarray", b: "np.ndarray") -> "np.ndarray":
    import numpy as np

    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    t = b[2] - a[2]
    return np.asarray(
        [c * dx + s * dy, -s * dx + c * dy,
         np.arctan2(np.sin(t), np.cos(t))], np.float64
    )


def se2_to_se3_np(p: "np.ndarray") -> "np.ndarray":
    import numpy as np

    c, s = np.cos(p[2]), np.sin(p[2])
    T = np.eye(4, dtype=np.float64)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = p[0], p[1]
    return T


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_hat(w):
    """Skew-symmetric matrix of (..., 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    rows = [
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def so3_exp(w):
    """Rodrigues formula with Taylor guard near 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos t)/t^2 with series fallback
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2.clip(1e-16))
    W = so3_hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * _mm(W, W)


def so3_log(R):
    """Log map SO(3) -> R^3, robust near 0 and pi.

    theta comes from atan2(|vee(R - R^T)|/2, (trace-1)/2) rather than
    arccos: arccos collapses to ~sqrt(eps) = 3e-4 rad of noise near the
    identity in f32 (and its derivative blows up at the clip boundary),
    while atan2 keeps full relative precision for the small rotations the
    pose-graph residuals live on."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = (trace - 1.0) * 0.5
    # vee of (R - R^T)/2;  |v| = sin(theta) for theta in [0, pi]
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    ) * 0.5
    sin2 = jnp.sum(v * v, axis=-1)
    # sqrt guard: keeps the backward pass finite at exactly theta = 0
    sin_t = jnp.sqrt(sin2 + _EPS * _EPS)
    theta = jnp.arctan2(sin_t, cos_t)
    small = theta < 1e-4
    near_pi = theta > jnp.pi - 1e-3
    scale = jnp.where(small, 1.0 + theta * theta / 6.0, theta / sin_t)
    w_generic = v * scale[..., None]
    # near pi: use diagonal formulation  w = theta * axis,  axis from R+I columns
    B = (R + jnp.eye(3, dtype=R.dtype)) * 0.5  # = axis axis^T near pi (approx)
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    # floor strictly above 0: sqrt' is infinite at 0 and this log is
    # differentiated by the pose-graph GN solver — an exactly-pi rotation
    # (diag entry exactly 0) would otherwise emit NaN in the backward pass
    axis = jnp.sqrt(jnp.clip(diag, 1e-10, None))
    # fix signs using off-diagonals relative to largest axis component
    signs = jnp.sign(
        jnp.stack(
            [
                R[..., 2, 1] - R[..., 1, 2],
                R[..., 0, 2] - R[..., 2, 0],
                R[..., 1, 0] - R[..., 0, 1],
            ],
            axis=-1,
        )
        + 1e-20
    )
    axis = axis * signs
    norm = jnp.linalg.norm(axis, axis=-1, keepdims=True).clip(1e-12)
    w_pi = axis / norm * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2.clip(1e-16))
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta).clip(1e-16)
    )
    return I + b[..., None, None] * W + c[..., None, None] * _mm(W, W)


def _so3_left_jacobian_inv(w):
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    half_theta = theta * 0.5
    cot = jnp.cos(half_theta) / jnp.where(jnp.sin(half_theta) == 0, 1.0, jnp.sin(half_theta))
    k = jnp.where(
        small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - half_theta * cot) / theta2.clip(1e-16)
    )
    return I - 0.5 * W + k[..., None, None] * _mm(W, W)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_identity(dtype=jnp.float32):
    return jnp.eye(4, dtype=dtype)


def se3_from_rt(R, t):
    shape = R.shape[:-2]
    T = jnp.zeros(shape + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_exp(xi):
    """Exp map R^6 -> SE(3); xi = [rho, phi]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    J = _so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", J, rho, precision=_HI)
    return se3_from_rt(R, t)


def se3_log(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    Jinv = _so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Jinv, t, precision=_HI)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inv(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return se3_from_rt(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=_HI))


def se3_mul(A, B):
    return _mm(A, B)


def se3_between(A, B):
    """gtsam Pose3::between — A^{-1} B (laserPosegraphOptimization.cpp:523)."""
    return _mm(se3_inv(A), B)


def se3_apply(T, pts):
    """Transform points (..., N, 3) by SE(3) (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, pts, precision=_HI) + t[..., None, :]


# ---------------------------------------------------------------------------
# Euler RPY (gtsam convention: R = Rz(yaw) Ry(pitch) Rx(roll))
# ---------------------------------------------------------------------------

def rpy_to_rotmat(roll, pitch, yaw):
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    row0 = jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = jnp.stack([-sp, cp * sr, cp * cr], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def pose6d_to_se3(p):
    """[x, y, z, roll, pitch, yaw] -> 4x4, mirroring Pose6D (common.h:55-62)."""
    R = rpy_to_rotmat(p[..., 3], p[..., 4], p[..., 5])
    return se3_from_rt(R, p[..., :3])


def se3_to_pose6d(T):
    R = T[..., :3, :3]
    pitch = -jnp.arcsin(jnp.clip(R[..., 2, 0], -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.concatenate(
        [T[..., :3, 3], jnp.stack([roll, pitch, yaw], axis=-1)], axis=-1
    )

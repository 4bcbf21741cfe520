"""Radar odometry front-end: the capability of the ORORA node.

The reference runs odometry as a separate ROS process reading files and
publishing `/orora/odom` + `/orora/cloud_local`
(launch/navtech_radar_slam_mulran.launch:5-8, sc_pgo.launch:6-7).  Here the
whole per-scan-pair computation — cen2019 extraction, Cartesian descriptor
matching, ORORA-style robust registration — is ONE jitted function
(`odometry_step`); the host-side `RadarOdometry` class only holds the tiny
carry state (previous scan's features/descriptors and the accumulated pose).

This is the framework's flagship compute path: `make_odometry_step(cfg)`
returns the jittable (scan_pair -> relative pose) function used by
`__graft_entry__.entry()`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from navtech_radar_slam_tpu.config import SlamConfig
from navtech_radar_slam_tpu.ops import cen2019, features, registration
from navtech_radar_slam_tpu.utils import geometry as geo


class ScanFeatures(NamedTuple):
    """Per-scan device-resident front-end state.

    ``xy`` is RAW (as measured, skewed by platform motion during the sweep);
    de-skewed views are derived per registration (deskew_features) so the
    carry never accumulates twist-estimate errors."""

    xy: jnp.ndarray        # (K, 2) sensor-frame feature positions (m), raw
    desc: jnp.ndarray      # (K, D) normalized constellation descriptors
    power: jnp.ndarray     # (K,)
    valid: jnp.ndarray     # (K,) bool
    ranges: jnp.ndarray    # (K,) range of each feature (m)
    ray_frac: jnp.ndarray  # (K,) sweep fraction of the feature's ray


def motion_compensate(xy: jnp.ndarray, ray_frac: jnp.ndarray,
                      twist: jnp.ndarray) -> jnp.ndarray:
    """De-skew features for platform motion during the sweep (yeti
    capability, /root/reference/README.md:100-111).

    A ray sampled at sweep fraction f sees the world from the pose
    f * twist (twist = estimated motion over one sweep, [dx, dy, dtheta]).
    Points are re-expressed in the sweep-start frame:
    p' = R(f*dtheta) p + f*[dx, dy]."""
    f = ray_frac[:, None]
    th = ray_frac * twist[2]
    c, s = jnp.cos(th), jnp.sin(th)
    x, y = xy[:, 0], xy[:, 1]
    return jnp.stack(
        [c * x - s * y, s * x + c * y], axis=-1
    ) + f * twist[None, :2]


def doppler_compensate(xy: jnp.ndarray, twist: jnp.ndarray,
                       beta: float, scan_rate_hz: float) -> jnp.ndarray:
    """Undo the FMCW Doppler range shift (yeti capability,
    /root/reference/README.md:100-111).

    A static target seen from a sensor moving with velocity v has range
    rate rdot = -d̂·v (d̂ = beam unit vector), and an FMCW radar measures
    r_meas = r_true + beta * rdot.  Given the per-sweep twist estimate
    (sensor velocity v ≈ twist[:2] * scan_rate, sweep-start frame), the
    correction is r_true = r_meas + beta * (d̂·v).  Chirp direction flips
    the sign of beta — make ``doppler_beta`` negative for down-chirp radars.
    """
    v = twist[:2] * scan_rate_hz
    r = jnp.linalg.norm(xy, axis=-1, keepdims=True)
    d = xy / jnp.maximum(r, 1e-6)
    r_true = r + beta * jnp.sum(d * v[None, :], axis=-1, keepdims=True)
    return d * r_true


def _with_xy(feats: ScanFeatures, xy: jnp.ndarray,
             fcfg) -> ScanFeatures:
    """Replace positions and rebuild the (position-dependent) descriptors."""
    desc = features.constellation_descriptors(xy, feats.power, feats.valid, fcfg)
    return feats._replace(
        xy=xy,
        desc=jnp.where(feats.valid[:, None], desc, 0.0),
        ranges=jnp.linalg.norm(xy, axis=-1),
    )


def _deskew_xy(xy: jnp.ndarray, frac: jnp.ndarray, twist: jnp.ndarray,
               cfg: SlamConfig) -> jnp.ndarray:
    """Positions-only de-skew: Doppler is undone first (it acts on the
    measured range along each beam at the ray's own sample time), then the
    motion skew re-expresses all rays in the sweep-start frame."""
    if cfg.features.doppler_compensation:
        xy = doppler_compensate(
            xy, twist, cfg.features.doppler_beta, cfg.radar.scan_rate_hz
        )
    if cfg.features.motion_compensation:
        xy = motion_compensate(xy, frac, twist)
    return xy


def deskew_features(feats: ScanFeatures, twist: jnp.ndarray,
                    cfg: SlamConfig) -> ScanFeatures:
    """De-skewed view of a raw feature set (descriptors rebuilt)."""
    xy = _deskew_xy(feats.xy, feats.ray_frac, twist, cfg)
    return _with_xy(feats, xy, cfg.features)


def deskew_matches(matches, twist: jnp.ndarray, cfg: SlamConfig):
    """De-skew an already-matched correspondence set in place.

    Matching is done ONCE on the raw descriptors (the upstream yeti design:
    data association does not change across de-skew refinements — only the
    matched point geometry does), so each refinement is a cheap (M, 2)
    transform + re-registration instead of a full descriptor rebuild +
    re-match over K² pairs."""
    src = _deskew_xy(matches.src_xy, matches.src_frac, twist, cfg)
    dst = _deskew_xy(matches.dst_xy, matches.dst_frac, twist, cfg)
    v = matches.valid
    return matches._replace(
        src_xy=jnp.where(v[:, None], src, 0.0),
        dst_xy=jnp.where(v[:, None], dst, 0.0),
        src_range=jnp.linalg.norm(src, axis=-1) * v,
        dst_range=jnp.linalg.norm(dst, axis=-1) * v,
    )


def extract_scan_features(power: jnp.ndarray, azimuths: jnp.ndarray,
                          cfg: SlamConfig, ray_valid=None) -> ScanFeatures:
    """cen2019 peaks -> metric xy -> rotation-invariant constellation
    descriptors (ops.features.constellation_descriptors).

    ``power`` may be float in [0, 1] OR raw uint8 sensor bytes; uint8 is
    normalized ON DEVICE.  Streaming raw bytes to the device cuts the
    host->device transfer 4x (5.5 -> 1.4 MB/scan).

    ``ray_valid`` ((NA,) bool, optional): per-azimuth validity from the
    sensor (the 11th metadata byte of the polar oxford form,
    /root/reference/README.md:70-71, decoded by both loaders).  Rays the
    sensor marked invalid are zeroed ON DEVICE before feature extraction
    so their garbage returns can never become features.

    A uint8 input whose trailing dim is padded_range_bins // 2 is the
    PACKED 4-bit companded wire format (data/packing.py — half the
    host->device bytes on the link-bound streaming path), unpacked on
    device: code q -> power (q/15)^2 in [0, 1]."""
    if ray_valid is not None:
        # zeroing the raw bytes zeroes both nibbles of the packed format
        # too, so masking commutes with the unpack below
        power = power * ray_valid.astype(power.dtype)[:, None]
    if (power.dtype == jnp.uint8
            and 2 * power.shape[-1] == cfg.radar.padded_range_bins):
        hi = (power >> 4).astype(jnp.float32)
        lo = (power & 0xF).astype(jnp.float32)
        q = jnp.stack([hi, lo], axis=-1).reshape(
            power.shape[:-1] + (2 * power.shape[-1],)
        )
        power = jnp.square(q * (1.0 / 15.0))
    elif power.dtype == jnp.uint8:
        power = power.astype(jnp.float32) * (1.0 / 255.0)
    feats = cen2019.extract_features(power, cfg.features, cfg.radar)
    xy = cen2019.features_to_xy(feats, azimuths, cfg.radar)
    desc = features.constellation_descriptors(
        xy, feats.power, feats.valid, cfg.features
    )
    ray_frac = (
        feats.azimuth_idx.astype(jnp.float32) + 0.5
    ) / cfg.radar.num_azimuths
    return ScanFeatures(
        xy=xy,
        desc=jnp.where(feats.valid[:, None], desc, 0.0),
        power=feats.power,
        valid=feats.valid,
        ranges=jnp.linalg.norm(xy, axis=-1),
        ray_frac=ray_frac,
    )


def match_feature_pair(prev: ScanFeatures, curr: ScanFeatures,
                       cfg: SlamConfig) -> features.MatchSet:
    return features.match_features(
        prev.desc, curr.desc, prev.xy, curr.xy, prev.valid, curr.valid,
        cfg.features, prev.ray_frac, curr.ray_frac,
    )


def register_feature_pair(
    prev: ScanFeatures, curr: ScanFeatures, cfg: SlamConfig
) -> registration.RegistrationResult:
    matches = match_feature_pair(prev, curr, cfg)
    return registration.register_scans(matches, cfg.registration)


def odometry_step(
    power: jnp.ndarray,
    azimuths: jnp.ndarray,
    prev: ScanFeatures,
    twist: jnp.ndarray,
    cfg: SlamConfig,
    ray_valid=None,
) -> Tuple[ScanFeatures, registration.RegistrationResult, ScanFeatures]:
    """One front-end step: extract current scan, register against previous.
    Returns (raw carry, result, de-skewed features for downstream use).

    With motion compensation on, the yeti-style iterate runs entirely
    inside the step: match ONCE on raw descriptors (association is stable
    under de-skew — the upstream yeti design), register for a seed twist,
    then de-skew the matched correspondence set with the shared
    (constant-velocity) twist estimate and re-register — twice.  Each
    refinement costs an (M, 2) transform + the robust solve instead of a
    K² descriptor rebuild + re-match.  The carry stays RAW, so twist errors
    never feed forward between frames.

    Pure function of (scan, carry) -> (carry', result); jit it once and feed
    scans — the reference's file-driven per-scan loop (SURVEY §3.5) becomes
    repeated invocation of this compiled program."""
    curr = extract_scan_features(power, azimuths, cfg, ray_valid)
    matches = match_feature_pair(prev, curr, cfg)
    res = registration.register_scans(matches, cfg.registration)
    if not (cfg.features.motion_compensation
            or cfg.features.doppler_compensation):
        return curr, res, curr

    t = jnp.where(res.ok, res.rel_pose, twist)
    for _ in range(2):
        m_d = deskew_matches(matches, t, cfg)
        res = registration.register_scans(m_d, cfg.registration)
        t = jnp.where(res.ok, res.rel_pose, t)
    # carry stays raw; the de-skewed positions are what downstream consumers
    # (keyframe store, ScanContext, ICP) see.  Descriptors are NOT rebuilt:
    # no downstream consumer reads curr_out.desc (the SC descriptor bank is
    # built from positions by the engine's _make_desc).
    curr_out = curr._replace(
        xy=_deskew_xy(curr.xy, curr.ray_frac, t, cfg)
    )
    curr_out = curr_out._replace(
        ranges=jnp.linalg.norm(curr_out.xy, axis=-1)
    )
    return curr, res, curr_out


def make_odometry_step(cfg: SlamConfig):
    """Jitted (power, azimuths, prev_features) -> (features, result)."""
    return jax.jit(functools.partial(odometry_step, cfg=cfg))


def make_odometry_sequence(cfg: SlamConfig, return_features: bool = False):
    """Device-side streaming odometry: ONE dispatch advances a whole chunk
    of S consecutive scans with `lax.scan` over the odometry step.

    The host per-scan loop pays one dispatch + one (ok, rel) fetch per
    scan.  Scanning on device amortizes it to one dispatch + one fetch per *chunk*,
    so sequential (carry-dependent) throughput approaches device speed; the
    reference has no analogue (its file loop is host-bound by design,
    README.md:27).

    Returns jitted
        (powers (S, NA, NB), azimuths (NA,), prev: ScanFeatures,
         twist (3,), coast ()) ->
        (prev', twist', coast', rels (S, 3), oks (S,), num_inliers (S,))

    `rels[i]` is the increment to apply at scan i (the registration result
    when ok, else the constant-velocity coast — zeroed once the coast
    exceeds cfg.registration.max_coast_frames, matching
    RadarOdometry.process's host semantics); compose poses on host in f64.

    With ``return_features=True`` two trailing outputs are appended:
    per-scan de-skewed feature positions (S, K, 2) and validity (S, K) —
    what keyframing / ScanContext / ICP consume (SlamEngine.process_chunk).
    """
    max_coast = cfg.registration.max_coast_frames

    def seq(powers, azimuths, prev, twist, coast, ray_valids=None):
        # ray_valids ((S, NA) bool, optional): zero sensor-marked invalid
        # rays on device before extraction (polar-oxford-form validity
        # byte, /root/reference/README.md:70-71)
        if ray_valids is not None:
            powers = powers * ray_valids.astype(powers.dtype)[:, :, None]
        # azimuths: (NA,) shared across the chunk, or (S, NA) per scan
        # (MulRan embeds per-ray encoder angles that differ scan to scan)
        if azimuths.ndim == 1:
            azimuths = jnp.broadcast_to(
                azimuths, (powers.shape[0],) + azimuths.shape
            )

        def body(carry, xs):
            power, az = xs
            prev, twist, coast = carry
            curr, res, curr_out = odometry_step(power, az, prev, twist, cfg)
            coast = jnp.where(res.ok, 0, coast + 1)
            applied = jnp.where(
                res.ok, res.rel_pose,
                jnp.where(coast > max_coast, jnp.zeros(3, twist.dtype), twist),
            )
            out = (applied, res.ok, res.num_inliers)
            if return_features:
                # de-skewed positions: what keyframing / ScanContext / ICP
                # consume (matches the host path's curr_out)
                out = out + (curr_out.xy, curr_out.valid)
            return (curr, applied, coast), out

        (prev, twist, coast), outs = jax.lax.scan(
            body, (prev, twist, coast), (powers, azimuths)
        )
        return (prev, twist, coast) + tuple(outs)

    return jax.jit(seq)


def make_batched_odometry_step(cfg: SlamConfig):
    """Data-parallel front-end: one jitted program advancing B independent
    scan streams at once — vmap over the full odometry step.

    A single stream is latency-bound (the device idles between its many
    small fused ops); batching B streams widens every op B-fold.  This is the deployment shape for mapping
    fleets / dataset reprocessing: (B, num_azimuths, padded_range_bins)
    scans in, B relative poses out.  Nothing exists in the reference to
    compare — one process handles one sensor (SURVEY §1 L4)."""
    step = functools.partial(odometry_step, cfg=cfg)
    return jax.jit(jax.vmap(step, in_axes=(0, None, 0, 0)))


class RadarOdometry:
    """Host-side accumulator mirroring the ORORA node's output contract:
    per scan it yields the accumulated SE(2) pose (the `/orora/odom` stream)
    and the current feature cloud (the `/orora/cloud_local` stream)."""

    def __init__(self, cfg: Optional[SlamConfig] = None):
        self.cfg = cfg or SlamConfig()
        self._step = make_odometry_step(self.cfg)
        self._extract = jax.jit(
            functools.partial(extract_scan_features, cfg=self.cfg)
        )
        self.prev: Optional[ScanFeatures] = None
        self.pose = np.zeros(3)          # accumulated [x, y, theta]
        self.num_scans = 0
        self.last_result: Optional[registration.RegistrationResult] = None
        #: host copy of the last step's (ok, rel_pose) — one device fetch
        self.last_ok: bool = False
        self.last_rel = np.zeros(3)      # constant-velocity fallback
        #: the increment actually composed into `pose` last scan (= last_rel
        #: or the coast fallback) — what downstream gates should integrate
        self.last_applied_rel = np.zeros(3)
        self.num_failures = 0
        self._coast = 0
        self._az_dev: Optional[jnp.ndarray] = None

    def default_azimuths(self) -> np.ndarray:
        na = self.cfg.radar.num_azimuths
        return (np.arange(na, dtype=np.float32) + 0.5) / na * 2.0 * np.pi

    def process(self, power, azimuths=None,
                ray_valid=None) -> Tuple[np.ndarray, ScanFeatures]:
        """Feed one polar scan; returns (accumulated pose, scan features).

        Host discipline: the only device interactions per scan are the scan
        upload, one jitted step dispatch, and ONE fetch of (ok, rel_pose);
        pose accumulation is host numpy (an eager jnp op is a device
        dispatch each).

        ``ray_valid`` ((NA,) bool, optional): sensor per-azimuth validity
        (polar-oxford-form metadata byte); invalid rays are zeroed on
        device before extraction."""
        if azimuths is None:
            if self._az_dev is None:
                self._az_dev = jnp.asarray(self.default_azimuths())
            azimuths = self._az_dev
        else:
            azimuths = jnp.asarray(azimuths)
        power = jnp.asarray(power)
        if ray_valid is not None:
            ray_valid = jnp.asarray(ray_valid)
        if self.prev is None:
            self.prev = self._extract(power, azimuths, ray_valid=ray_valid)
            self.num_scans = 1
            return self.pose.copy(), self.prev
        curr, result, curr_out = self._step(
            power, azimuths, self.prev,
            jnp.asarray(self.last_rel, jnp.float32),
            ray_valid=ray_valid,
        )
        self.last_result = result
        ok, rel_dev = jax.device_get((result.ok, result.rel_pose))
        self.last_ok = bool(ok)
        if self.last_ok:
            rel = np.asarray(rel_dev, np.float64)
            self.last_rel = rel
            self._coast = 0
        else:
            # constant-velocity fallback: reuse the previous increment —
            # but stop blind extrapolation after max_coast_frames failures
            self.num_failures += 1
            self._coast += 1
            if self._coast > self.cfg.registration.max_coast_frames:
                self.last_rel = np.zeros(3)
            rel = self.last_rel
        self.last_applied_rel = np.asarray(rel, np.float64)
        self.pose = geo.se2_mul_np(self.pose, self.last_applied_rel)
        self.prev = curr
        self.num_scans += 1
        return self.pose.copy(), curr_out

"""MulRan / Oxford "polar form" Navtech radar dataset reader.

The reference's front-end consumes radar scans directly from files — "not ROS
subscription" (README.md:27): each scan is a grayscale PNG whose rows are
azimuths (400) and whose first 11 columns embed per-ray metadata
(README.md:70-71, oxford-radar-robotcar format):

    cols 0-7  : int64 little-endian UNIX timestamp (ns or us) of the ray
    cols 8-9  : uint16 azimuth encoder tick (0..ENCODER_SIZE-1)
    col 10    : validity byte
    cols 11.. : power returns, uint8

Filenames are the scan timestamps (``<stamp>.png``), ascending.

Decoding is pure NumPy on the host (PNG codec in data/png.py); the fast path
is the C++ runtime loader (navtech_radar_slam_tpu/runtime) which decodes +
prefetches scans on worker threads while the device computes.  This module is
the reference decoder and the fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from navtech_radar_slam_tpu.config import RadarConfig
from navtech_radar_slam_tpu.data.png import read_gray_png

ENCODER_SIZE = 5600  # Navtech azimuth encoder ticks per revolution


@dataclass
class PolarScan:
    """One decoded radar scan (host-side, NumPy)."""

    #: (num_azimuths, padded_range_bins) power: float32 in [0, 1], or raw
    #: uint8 bytes when decoded with raw_u8=True (normalize-on-device path —
    #: the jitted front-end casts /255 on chip; 4x less host->device traffic)
    power: np.ndarray
    #: (num_azimuths,) float64 per-ray UNIX timestamps (seconds)
    ray_timestamps: np.ndarray
    #: (num_azimuths,) float32 azimuth angles (rad, [0, 2pi))
    azimuths: np.ndarray
    #: (num_azimuths,) bool validity
    valid: np.ndarray
    #: scan timestamp (seconds; from filename)
    timestamp: float


def _load_image(path: str) -> np.ndarray:
    return read_gray_png(path)


def decode_polar_scan(
    img: np.ndarray,
    cfg: RadarConfig,
    timestamp: float = 0.0,
    raw_u8: bool = False,
) -> PolarScan:
    """Decode a raw polar image (uint8, rows=azimuths) into a PolarScan.

    Tolerates images without the 11 metadata columns (e.g. synthetic scans):
    if the width is <= num_range_bins, the whole image is power data.
    ``raw_u8=True`` keeps power as the raw bytes (see PolarScan.power).
    """
    img = np.asarray(img)
    na = cfg.num_azimuths
    if img.shape[0] != na:
        raise ValueError(f"expected {na} azimuth rows, got {img.shape[0]}")

    has_meta = img.shape[1] > cfg.num_range_bins
    if has_meta:
        meta = img[:, : cfg.meta_columns]
        power_u8 = img[:, cfg.meta_columns :]
        stamps = (
            meta[:, :8].copy().view(np.int64).reshape(na).astype(np.float64)
        )
        # MulRan stamps are in ns if huge, else us (oxford uses us)
        scale = 1e-9 if stamps.max() > 1e17 else 1e-6
        ray_ts = stamps * scale
        enc = meta[:, 8:10].copy().view(np.uint16).reshape(na).astype(np.float32)
        azimuths = enc / ENCODER_SIZE * (2.0 * np.pi)
        valid = meta[:, 10] > 0
    else:
        power_u8 = img
        ray_ts = np.full((na,), timestamp, np.float64)
        azimuths = (np.arange(na, dtype=np.float32) + 0.5) / na * (2.0 * np.pi)
        valid = np.ones((na,), bool)

    nb = cfg.num_range_bins
    w = min(nb, power_u8.shape[1])
    if raw_u8:
        power = np.zeros((na, cfg.padded_range_bins), np.uint8)
        power[:, :w] = power_u8[:, :w]
    else:
        power = np.zeros((na, cfg.padded_range_bins), np.float32)
        power[:, :w] = power_u8[:, :w].astype(np.float32) / 255.0
    return PolarScan(
        power=power,
        ray_timestamps=ray_ts,
        azimuths=azimuths,
        valid=valid,
        timestamp=timestamp,
    )


class MulranRadarDataset:
    """Iterates decoded scans from a MulRan sequence directory.

    The directory layout matches the reference's launch contract: the
    ``seq_dir`` roslaunch arg (navtech_radar_slam_mulran.launch:2,6) points
    at a sequence containing ``polar_oxford_form/`` (or the scans directly),
    and optionally ``global_pose.csv`` (MulRan ground truth) and
    ``gps.csv``.
    """

    SCAN_SUBDIRS = ("polar_oxford_form", "sensor_data/radar/polar_oxford_form", "polar", "")

    def __init__(self, seq_dir: str, cfg: Optional[RadarConfig] = None,
                 raw_u8: bool = False):
        self.cfg = cfg or RadarConfig()
        self.raw_u8 = raw_u8
        self.seq_dir = seq_dir
        self.scan_dir = self._find_scan_dir(seq_dir)
        self.scan_files = sorted(
            f for f in os.listdir(self.scan_dir) if f.endswith(".png")
        )
        if not self.scan_files:
            raise FileNotFoundError(f"no .png scans under {self.scan_dir}")

    @classmethod
    def _find_scan_dir(cls, seq_dir: str) -> str:
        for sub in cls.SCAN_SUBDIRS:
            d = os.path.join(seq_dir, sub) if sub else seq_dir
            if os.path.isdir(d) and any(f.endswith(".png") for f in os.listdir(d)):
                return d
        raise FileNotFoundError(f"no radar scan directory found under {seq_dir}")

    def __len__(self) -> int:
        return len(self.scan_files)

    def timestamp(self, idx: int) -> float:
        stem = os.path.splitext(self.scan_files[idx])[0]
        t = float(int(stem))
        return t * (1e-9 if t > 1e17 else 1e-6)

    def __getitem__(self, idx: int) -> PolarScan:
        path = os.path.join(self.scan_dir, self.scan_files[idx])
        return decode_polar_scan(
            _load_image(path), self.cfg, self.timestamp(idx),
            raw_u8=self.raw_u8,
        )

    def __iter__(self) -> Iterator[PolarScan]:
        for i in range(len(self)):
            yield self[i]


def load_global_pose_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """MulRan global_pose.csv: stamp_ns, then a row-major 3x4 [R|t].

    Returns (timestamps_sec (N,), poses (N, 4, 4))."""
    raw = np.loadtxt(path, delimiter=",")
    ts = raw[:, 0] * 1e-9
    mats = raw[:, 1:13].reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(raw), 1, 1))
    poses[:, :3, :4] = mats
    return ts, poses


def load_gps_csv(path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Tolerant MulRan gps.csv reader: stamp_ns, lat, lon, alt[, cov...].

    The reference consumes /gps/fix and uses altitude only
    (laserPosegraphOptimization.cpp:439-451, 526-533).  Real gps.csv files
    in the wild carry header lines, truncated rows, and occasionally no
    altitude column; one bad line must degrade to a skipped fix, not kill
    the run at startup.  Returns (times_sec, altitudes, num_skipped);
    rows shorter than 4 columns fall back to column 1 for altitude
    (a 2-column stamp,alt layout) and rows with no parseable stamp or
    altitude are skipped."""
    times, alts = [], []
    skipped = 0
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",")]
            if not parts or not parts[0] or parts[0].startswith("#"):
                continue
            try:
                t = float(parts[0])
            except ValueError:
                skipped += 1          # header or garbage line
                continue
            alt = None
            for col in (3, 1):        # MulRan alt column, then 2-col layout
                if len(parts) > col:
                    try:
                        alt = float(parts[col])
                        break
                    except ValueError:
                        pass
            if alt is None or not np.isfinite(alt) or not np.isfinite(t):
                skipped += 1
                continue
            times.append(t * 1e-9)
            alts.append(alt)
    return np.asarray(times), np.asarray(alts), skipped


def save_trajectory_tum(path: str, timestamps: Sequence[float], poses: np.ndarray) -> None:
    """Write TUM-format trajectory (t x y z qx qy qz qw) — the map/trajectory
    export the reference lists as an unmet TODO (README.md:136-142)."""
    from scipy.spatial.transform import Rotation

    poses = np.asarray(poses)
    q = Rotation.from_matrix(poses[:, :3, :3]).as_quat()  # xyzw
    with open(path, "w") as f:
        for i, t in enumerate(timestamps):
            x, y, z = poses[i, :3, 3]
            f.write(
                f"{t:.9f} {x:.6f} {y:.6f} {z:.6f} "
                f"{q[i,0]:.6f} {q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f}\n"
            )

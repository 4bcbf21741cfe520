"""Write a full-scale MulRan-format radar sequence from the simulator.

Produces exactly the on-disk layout the reference's launch contract consumes
(`seq_dir` arg, navtech_radar_slam_mulran.launch:2,6; polar-form PNGs with
embedded per-ray metadata per /root/reference/README.md:70-71):

    <out>/polar_oxford_form/<stamp_us>.png   rows = 400 azimuths;
        cols 0-7  int64 LE per-ray UNIX timestamp (us)
        cols 8-9  uint16 LE azimuth encoder tick (0..5599)
        col  10   validity byte (255)
        cols 11.. uint8 power returns (3360 range bins)
    <out>/global_pose.csv                    stamp_ns, row-major 3x4 pose

so the REAL pipeline — native C++ PNG loader, per-ray decode, CLI, eval —
runs unmodified on it.  This is the rehearsal harness for the MulRan
KAIST03/Riverside03 runs the reference validates on (README.md:69-86),
usable in an environment with no dataset egress.

Scans are motion-distorted (each ray rendered from the pose at its sample
time — the real Navtech sweep behavior) so the de-skew path is exercised,
and optional dropout windows attenuate returns to exercise odometry
failure/coast handling.

    python -m navtech_radar_slam_tpu.data.make_sequence \
        --out /tmp/seq --scans 600 --radius 30 --speed 6 \
        --dropout 250:6 --dropout 400:4
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from navtech_radar_slam_tpu.config import RadarConfig
from navtech_radar_slam_tpu.data.mulran import ENCODER_SIZE
from navtech_radar_slam_tpu.data.png import write_gray_png
from navtech_radar_slam_tpu.data.synthetic import RadarSimulator, SimConfig

START_STAMP_US = 1_600_000_000_000_000  # arbitrary epoch, us
# a spawned renderer takes about a second to start, some eight scans' work
_SCANS_PER_WORKER = 32


def encode_polar_png(power: np.ndarray, stamp_us: int, rc: RadarConfig,
                     sweep_period_s: float) -> np.ndarray:
    """(NA, >=num_range_bins) float [0,1] -> uint8 image with meta columns."""
    na = rc.num_azimuths
    img = np.zeros((na, rc.meta_columns + rc.num_range_bins), np.uint8)
    img[:, rc.meta_columns:] = (
        np.clip(power[:, : rc.num_range_bins], 0.0, 1.0) * 255.0
    ).astype(np.uint8)
    ray_dt_us = sweep_period_s * 1e6 / na
    for a in range(na):
        ts = np.int64(stamp_us + round(a * ray_dt_us))
        img[a, :8] = np.frombuffer(ts.astype("<i8").tobytes(), np.uint8)
        enc = np.uint16(int(a / na * ENCODER_SIZE))
        img[a, 8:10] = np.frombuffer(enc.astype("<u2").tobytes(), np.uint8)
        img[a, 10] = 255
    return img


def _write_scan(sim, seq_dir, seed, period, distort, job):
    """Render one scan and write its PNG (a module-level function so that
    worker processes can run it)."""
    i, pose, end_pose, atten, stamp_us = job
    power = sim.render(
        pose, noise_seed=seed * 100_003 + i,
        end_pose=end_pose if distort else None,
        t=i * period,
    )
    power = power * atten if atten != 1.0 else power
    img = encode_polar_png(power, stamp_us, sim.radar, period)
    write_gray_png(os.path.join(seq_dir, f"{stamp_us}.png"), img)


def write_sequence(
    out_dir: str,
    num_scans: int = 600,
    radius: float = 30.0,
    speed: float = 6.0,
    dropouts=(),           # iterable of (start_scan, length) attenuation windows
    dropout_atten: float = 0.15,
    distort: bool = True,
    seed: int = 0,
    sim_cfg: SimConfig = None,
    progress: bool = False,
    start_stamp_us: int = START_STAMP_US,
    gps: bool = False,
    gps_rate_hz: float = 10.0,
    gps_alt0: float = 70.0,
    world: str = "circuit",
) -> np.ndarray:
    """Render + write the sequence; returns the (N, 3) ground-truth poses.

    ``gps=True`` additionally writes a MulRan-format gps.csv (stamp_ns,
    lat, lon, alt — the reference consumes altitude only,
    laserPosegraphOptimization.cpp:526-533) at ``gps_rate_hz`` with
    ABSOLUTE altitudes around ``gps_alt0`` (the engine must latch the
    datum; a flat-zero stream would hide datum bugs).

    ``world="alias"`` builds the perceptual-aliasing course (VERDICT r4
    next #4): the landmark field cloned (1.25 m jitter) at a distant site,
    plus dynamic scatterers; the trajectory laps site A, transits to the
    clone site B, and laps there — ScanContext produces below-threshold
    cross-site candidates that submap ICP must reject.

    Scans render in parallel, one process per CPU but at most one per
    ``_SCANS_PER_WORKER`` scans; a short sequence renders in this
    process."""
    rc = RadarConfig()
    if world == "alias":
        if sim_cfg is None:
            from navtech_radar_slam_tpu.data.synthetic import SimConfig

            offset = 10.0 * radius
            # jitter 1.25 m (not the small-world test's 1.0): at this
            # world's longer feature ranges the whitened ICP gate's
            # per-correspondence variance grows with r, so the clone needs
            # a larger geometric offset to stay unambiguously rejectable
            # while its SC distance stays below the 0.45 candidate gate
            # (measured 0.33-0.44 at 1.25; 2/5 poses exceed the gate at 1.5)
            sim_cfg = SimConfig(
                num_landmarks=300, world_size=8.0 * radius,
                alias_offset=(offset, 0.0), alias_jitter=1.25,
                alias_keep=1.0, num_dynamic=20, seed=seed,
            )
        sim = RadarSimulator(rc, sim_cfg)
        gt = sim.two_site_trajectory(
            num_scans + 1, radius=radius, speed=speed,
            site_offset=sim_cfg.alias_offset, laps_a=1.6,
        )
    else:
        sim = RadarSimulator(rc, sim_cfg)
        gt = sim.circuit_trajectory(num_scans + 1, radius=radius, speed=speed)

    seq = os.path.join(out_dir, "polar_oxford_form")
    os.makedirs(seq, exist_ok=True)
    period = 1.0 / rc.scan_rate_hz
    drop = np.ones(num_scans)
    for start, length in dropouts:
        drop[start:start + length] = dropout_atten

    stamps = [start_stamp_us + round(i * period * 1e6)
              for i in range(num_scans)]
    jobs = [(i, gt[i], gt[i + 1], drop[i], stamps[i])
            for i in range(num_scans)]
    work = functools.partial(_write_scan, sim, seq, seed, period, distort)
    workers = min(os.cpu_count() or 1, num_scans // _SCANS_PER_WORKER)
    with contextlib.ExitStack() as stack:
        if workers > 1:
            pool = stack.enter_context(ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")))
            done = pool.map(work, jobs, chunksize=8)
        else:
            done = map(work, jobs)
        for i, _ in enumerate(done):
            if progress and (i + 1) % 50 == 0:
                print(f"  rendered {i + 1}/{num_scans}", flush=True)

    rows = []
    for i in range(num_scans):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        m = np.array([[c, -s, 0.0, gt[i, 0]],
                      [s, c, 0.0, gt[i, 1]],
                      [0.0, 0.0, 1.0, 0.0]])
        rows.append([stamps[i] * 1000] + list(m.reshape(-1)))

    np.savetxt(os.path.join(out_dir, "global_pose.csv"),
               np.asarray(rows), delimiter=",")
    if gps:
        duration = num_scans * period
        n_fix = int(duration * gps_rate_hz)
        rng = np.random.default_rng(seed + 7)
        g_rows = []
        for j in range(n_fix):
            t_s = j / gps_rate_hz + 0.013      # offset off the scan stamps
            stamp_ns = (start_stamp_us + round(t_s * 1e6)) * 1000
            alt = gps_alt0 + 0.2 * np.sin(t_s / 30.0) + rng.normal(0, 0.05)
            g_rows.append([stamp_ns, 37.0, 127.0, alt])
        np.savetxt(os.path.join(out_dir, "gps.csv"), np.asarray(g_rows),
                   delimiter=",", fmt=["%d", "%.7f", "%.7f", "%.4f"])
    return gt[:num_scans]


def _parse_dropout(s: str):
    a, b = s.split(":")
    return int(a), int(b)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="navtech_radar_slam_tpu.data.make_sequence",
        description="Write a synthetic MulRan-format radar sequence",
    )
    p.add_argument("--out", required=True)
    p.add_argument("--scans", type=int, default=600)
    p.add_argument("--radius", type=float, default=30.0)
    p.add_argument("--speed", type=float, default=6.0)
    p.add_argument("--dropout", action="append", type=_parse_dropout,
                   default=[], metavar="START:LEN",
                   help="attenuate scans [START, START+LEN) (repeatable)")
    p.add_argument("--no_distort", action="store_true",
                   help="render instantaneous (undistorted) sweeps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stamp_offset_s", type=float, default=0.0,
                   help="offset the first scan's timestamp (distinct "
                        "sessions over one world need distinct stamps)")
    p.add_argument("--gps", action="store_true",
                   help="also write a MulRan-format gps.csv (absolute "
                        "altitudes ~70 m at 10 Hz)")
    p.add_argument("--world", default="circuit", choices=("circuit", "alias"),
                   help="'alias' = perceptual-aliasing two-site course "
                        "with dynamic scatterers (cross-site ScanContext "
                        "candidates that ICP must reject)")
    args = p.parse_args(argv)

    gt = write_sequence(
        args.out, num_scans=args.scans, radius=args.radius, speed=args.speed,
        dropouts=args.dropout, distort=not args.no_distort, seed=args.seed,
        progress=True,
        start_stamp_us=START_STAMP_US + round(args.stamp_offset_s * 1e6),
        gps=args.gps,
        world=args.world,
    )
    laps = args.speed * args.scans / (4.0 * 2 * np.pi * args.radius)
    print(f"wrote {args.scans} scans ({laps:.2f} laps of r={args.radius} m) "
          f"+ global_pose.csv to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

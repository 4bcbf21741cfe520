#!/usr/bin/env python
"""Smoke test of the full SLAM path on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases A-D
    python chip_smoke.py --mesh 4       # four cards: sharded vs single run

Phases (one card):
  A  device: nvidia-smi name and power limit, JAX devices; the JAX backend
     must be the GPU (no CPU fallback).
  B  CLI run: write a MulRan-format sequence with data.make_sequence
     (600 scans, r = 30 m, 6 m/s, two dropout windows, full 400 x 3360
     scans) and stream it through `python -m navtech_radar_slam_tpu.cli
     --chunk 16 --platform gpu` at the shipped defaults.  Fails unless
     ATE < 0.5 m, loop precision >= 0.98 and loop recall >= 0.9.
  C  the hot ops at full width against float64 NumPy references
     (ops/reference.py): cen2019 peaks, the ScanContext all-shift
     distance matrix over a 4096-entry bank, nearest neighbours at
     1024 x 8192.
  D  the GPU-only tests (tests/test_gpu_only.py).

With --mesh 4 only the sharded path runs: the same sequence through the
CLI with --mesh 4 and without a mesh, each held to the bounds of phase B,
and the two compared (keyframe count, loop overlap, keyframe positions).

The parent process never starts JAX: every phase that touches the card
runs in a child, one after another, so one process holds the card at a
time.  Any failure exits non-zero before the result line is printed.
Outputs go to chip_smoke_out/ (listed in .gitignore).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chip_smoke_out")
PKG = "navtech_radar_slam_tpu"

ATE_MAX_M = 0.5
PRECISION_MIN = 0.98
RECALL_MIN = 0.9


class SmokeFailure(Exception):
    pass


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def _run(cmd, timeout, env=None, capture=False):
    """Run a child from the repo root; a non-zero exit is a failure."""
    print(f"$ {' '.join(cmd)}", flush=True)
    t0 = time.time()
    proc = subprocess.run(
        cmd, cwd=ROOT, env=env, timeout=timeout, text=True,
        stdout=subprocess.PIPE if capture else None,
    )
    _check(proc.returncode == 0,
           f"{' '.join(cmd[:3])} exited {proc.returncode}")
    print(f"  ({time.time() - t0:.1f} s)", flush=True)
    return proc.stdout


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- phase A -----------------------------------------------------------------

_DEVICE_PROBE = """
import json, jax
print(jax.devices(), flush=True)
backend = jax.default_backend()
assert backend == "gpu", f"JAX backend is {backend}, not gpu"
d = jax.devices()
print(json.dumps({"platform": d[0].platform, "kind": d[0].device_kind,
                  "count": len(d)}))
"""


def phase_device(min_count: int) -> dict:
    print("== A: device", flush=True)
    card = _card()
    print(f"card: {card}", flush=True)
    out = _run([sys.executable, "-c", _DEVICE_PROBE], 300, capture=True)
    print(out.strip())
    device = json.loads(out.strip().splitlines()[-1])
    _check(device["platform"] == "gpu", f"device platform {device}")
    _check(device["count"] >= min_count,
           f"{device['count']} devices present, {min_count} needed")
    device["card"] = card
    return device


# -- phase B -----------------------------------------------------------------

def write_sequence(scans: int) -> str:
    seq = os.path.join(OUT, "seq")
    shutil.rmtree(seq, ignore_errors=True)
    _run([sys.executable, "-m", f"{PKG}.data.make_sequence", "--out", seq,
          "--scans", str(scans), "--radius", "30", "--speed", "6",
          "--dropout", "250:6", "--dropout", "400:4"], 900)
    return seq


def run_cli(seq: str, name: str, card: str, extra=()) -> dict:
    out_dir = os.path.join(OUT, name)
    shutil.rmtree(out_dir, ignore_errors=True)
    _run([sys.executable, "-m", f"{PKG}.cli", "--seq_dir", seq,
          "--output_dir", out_dir, "--chunk", "16", "--platform", "gpu",
          "--status_every", "160", *extra], 1200)
    with open(os.path.join(out_dir, "stats.json")) as f:
        stats = json.load(f)
    print(f"[{name}] ATE RMSE {stats['ate_rmse']} m, RTE {stats['rte']} m")
    print(f"[{name}] loops {stats['num_loops']}, recall "
          f"{stats['loop_recall']}, precision {stats['loop_precision']}")
    print(f"[{name}] odometry failures {stats['odometry_failures']}, "
          f"keyframes {stats['num_keyframes']} of {stats['num_scans']} scans")
    print(f"[{name}] warmup_s {stats['warmup_s']}, compile_s "
          f"{stats['compile_s']}, steady_scans_per_sec "
          f"{stats['steady_scans_per_sec']} on {card}")
    print(f"[{name}] loader {stats['loader']}, peak_bytes_in_use "
          f"{stats['peak_bytes_in_use']}", flush=True)
    ate, rec, prec = (stats["ate_rmse"], stats["loop_recall"],
                      stats["loop_precision"])
    _check(ate is not None and ate < ATE_MAX_M,
           f"[{name}] ATE {ate} m (bound {ATE_MAX_M})")
    _check(prec is not None and prec >= PRECISION_MIN,
           f"[{name}] loop precision {prec} (bound {PRECISION_MIN})")
    _check(rec is not None and rec >= RECALL_MIN,
           f"[{name}] loop recall {rec} (bound {RECALL_MIN})")
    stats["out_dir"] = out_dir
    return stats


# -- phase C (runs in a child: python chip_smoke.py --phase kernels) ----------

def kernels_phase() -> None:
    import numpy as np

    import jax
    import jax.numpy as jnp

    from navtech_radar_slam_tpu.config import ScanContextConfig, SlamConfig
    from navtech_radar_slam_tpu.data import RadarSimulator
    from navtech_radar_slam_tpu.ops import cen2019, icp, reference
    from navtech_radar_slam_tpu.ops import scancontext as sc
    from navtech_radar_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    _check(jax.default_backend() == "gpu",
           f"JAX backend is {jax.default_backend()}, not gpu")
    rng = np.random.default_rng(0)

    # cen2019 on a rendered full-width scan
    cfg = SlamConfig()
    scan = RadarSimulator(cfg.radar).render(
        np.asarray([5.0, -3.0, 0.7]), noise_seed=3)
    feats = jax.device_get(jax.jit(
        lambda p: cen2019.cen2019_features(p, cfg.features, cfg.radar)
    )(jnp.asarray(scan)))
    az, rb, pw = reference.cen2019_features_np(scan, cfg.features, cfg.radar)
    v = feats.valid
    dev = set(zip(feats.azimuth_idx[v].tolist(), feats.range_bin[v].tolist()))
    ref = set(zip(az.tolist(), rb.tolist()))
    differ = len(dev ^ ref)
    power_err = float(np.max(np.abs(np.sort(feats.power[v]) - np.sort(pw))))
    print(f"cen2019 {scan.shape}: {len(dev)} peaks (reference {len(ref)}), "
          f"{differ} differ (limit 1 %), max power error {power_err:.2e} "
          f"(atol 1e-5)")
    _check(len(dev) == len(ref) and differ <= 0.01 * len(ref),
           "cen2019 peak sets differ")
    _check(power_err <= 1e-5, "cen2019 peak powers differ")

    # ScanContext all-shift distance over a full bank
    scfg = ScanContextConfig()
    n_bank = SlamConfig().keyframes.max_keyframes
    bank = np.where(rng.random((n_bank, scfg.num_ring, scfg.num_sector))
                    < 0.2, 2.0, 0.0).astype(np.float32)
    query = np.roll(bank[123], 7, axis=1)
    dist = np.asarray(jax.jit(sc.sc_shift_distance_matrix)(
        jnp.asarray(query), jnp.asarray(bank)))
    ref_d = reference.sc_shift_distance_matrix_np(query, bank)
    atol = 1e-5
    err = float(np.max(np.abs(dist - ref_d)))
    best_dev, best_ref = dist.argmin(axis=1), ref_d.argmin(axis=1)
    rows = np.arange(n_bank)
    flips = int(np.sum((best_dev != best_ref)
                       & (ref_d[rows, best_dev] - ref_d[rows, best_ref]
                          > atol)))
    print(f"scancontext ({n_bank}, {scfg.num_ring}, {scfg.num_sector}) at "
          f"precision {sc.SC_PRECISION}: max error {err:.2e} (atol {atol}), "
          f"{flips} rows whose best shift disagrees beyond atol")
    _check(err <= atol, "scancontext distances differ")
    _check(flips == 0, "scancontext best shifts differ")
    _check(int(best_dev[123]) == 7 and dist[123, 7] < atol,
           "scancontext self-match lost")

    # nearest neighbours at the ICP problem size, invalid targets included
    icfg = cfg.icp
    src = rng.uniform(-200, 200, (icfg.max_query_points, 2)).astype(np.float32)
    tgt = rng.uniform(-200, 200, (icfg.max_target_points, 2)).astype(np.float32)
    tv = rng.random(icfg.max_target_points) > 0.2
    d_dev, i_dev = jax.device_get(jax.jit(icp.nearest_neighbors)(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(tv)))
    d_ref, i_ref = reference.nearest_neighbors_np(src, tgt, tv)
    mism = np.flatnonzero(i_dev != i_ref)
    d64 = lambda i, j: float(np.sum((src[i].astype(np.float64) - tgt[j]) ** 2))
    ties = [k for k in mism
            if abs(d64(k, i_dev[k]) - d_ref[k]) <= 1e-5 * d_ref[k]]
    rel = float(np.max(np.abs(d_dev - d_ref) / np.maximum(d_ref, 1e-30)))
    print(f"nearest neighbours {src.shape[0]} x {tgt.shape[0]}: "
          f"{len(mism)} index mismatches ({len(ties)} ties), max relative "
          f"distance error {rel:.2e} (rtol 1e-5)")
    _check(len(mism) == len(ties) and bool(tv[i_dev].all()),
           "nearest-neighbour indices differ")
    _check(rel <= 1e-5, "nearest-neighbour distances differ")


# -- phase D -----------------------------------------------------------------

def phase_gpu_tests() -> None:
    print("== D: GPU-only tests", flush=True)
    env = dict(os.environ, NRS_TESTS_GPU="1")
    out = _run([sys.executable, "-m", "pytest", "tests/test_gpu_only.py",
                "-q", "-rs", "-p", "no:cacheprovider"], 900, env=env,
               capture=True)
    print(out.strip()[-2000:])
    summary = out.strip().splitlines()[-1]
    _check("passed" in summary and "skipped" not in summary
           and "failed" not in summary and "error" not in summary,
           f"GPU-only tests: {summary}")


# -- mesh mode ----------------------------------------------------------------

def _loops(out_dir: str):
    path = os.path.join(out_dir, "loops.csv")
    if not os.path.exists(path):
        return []
    import numpy as np

    rows = np.atleast_2d(np.loadtxt(path, delimiter=",", skiprows=1))
    return [(int(r[0]), int(r[1])) for r in rows]


def compare_mesh(mesh_stats: dict, single_stats: dict) -> None:
    import numpy as np

    km, ks = mesh_stats["num_keyframes"], single_stats["num_keyframes"]
    _check(km == ks, f"keyframe counts differ: mesh {km}, single {ks}")
    lm, ls = _loops(mesh_stats["out_dir"]), _loops(single_stats["out_dir"])

    def matched(a, bs):
        return any(abs(a[0] - b[0]) <= 2 and abs(a[1] - b[1]) <= 2
                   for b in bs)

    hit_m = sum(matched(a, ls) for a in lm)
    hit_s = sum(matched(b, lm) for b in ls)
    print(f"loop overlap: {hit_m}/{len(lm)} mesh loops matched, "
          f"{hit_s}/{len(ls)} single loops matched (need half each)")
    _check(hit_m >= len(lm) // 2 and hit_s >= len(ls) // 2,
           "mesh and single loop sets do not overlap")
    tm = np.loadtxt(os.path.join(mesh_stats["out_dir"], "trajectory_tum.txt"))
    ts = np.loadtxt(os.path.join(single_stats["out_dir"],
                                 "trajectory_tum.txt"))
    gap = float(np.max(np.abs(tm[:, 1:4] - ts[:, 1:4])))
    print(f"keyframe positions: max difference {gap:.4f} m (limit 0.1 m)")
    _check(gap <= 0.1, "mesh and single trajectories differ")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scans", type=int, default=600,
                   help="sequence length (600 is the full run)")
    p.add_argument("--mesh", type=int, default=0,
                   help="run only the sharded path on this many cards")
    p.add_argument("--phase", choices=("kernels",), help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    try:
        if args.phase == "kernels":
            kernels_phase()
            return 0
        _check(os.path.isdir(os.path.join(ROOT, PKG)),
               f"{PKG}/ not found beside chip_smoke.py")
        os.makedirs(OUT, exist_ok=True)
        device = phase_device(max(1, args.mesh))
        card = device["card"]
        if args.mesh:
            print(f"== mesh: {args.mesh} cards vs one", flush=True)
            seq = write_sequence(args.scans)
            mesh_stats = run_cli(seq, f"mesh{args.mesh}", card,
                                 ("--mesh", str(args.mesh)))
            single_stats = run_cli(seq, "single", card)
            compare_mesh(mesh_stats, single_stats)
            count = args.mesh
        else:
            print("== B: CLI run", flush=True)
            run_cli(write_sequence(args.scans), "run", card)
            print("== C: ops against float64 references", flush=True)
            _run([sys.executable, os.path.abspath(__file__),
                  "--phase", "kernels"], 900)
            phase_gpu_tests()
            count = 1
    except (SmokeFailure, subprocess.TimeoutExpired, OSError, KeyError,
            ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

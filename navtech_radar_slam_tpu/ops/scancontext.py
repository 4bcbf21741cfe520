"""ScanContext place recognition as batched correlation.

Reproduces the capability of the reference's SCManager
(Scancontext.{h,cpp}) with a batched-matmul design:

  * descriptor: 20 rings x 60 sectors polar max-height image over 80 m with
    the z + 2.0 lift (Scancontext.h:83-89, makeScancontext cpp:151-195) —
    here one scatter-max over the feature cloud instead of a per-point loop;
  * ring key / sector key: row / column means (cpp:198-227);
  * distance: column-wise cosine distance skipping zero columns
    (distDirectSC, cpp:69-90) under the best circular column shift.  The
    reference brute-forces 60 sector-key shifts then searches ±10% column
    shifts per candidate (fastAlignUsingVkey cpp:93-113,
    distanceBtnScanContext cpp:116-148); here the *entire* bank x
    all-60-shifts search is a single (60, R*S) x (R*S, N) matmul plus a
    masked normalization, so no KD-tree, no candidate pruning, no
    tree rebuild every 30 inserts (cpp:347-360) — search cost is flat in N
    until the bank shards across chips (parallel/sharded_bank.py);
  * ring-key KNN prefilter (the reference's nanoflann stage, cpp:331-422)
    is kept as an *optional* cheap first stage for the sharded multi-host
    path, computed as a distance matmul rather than a KD-tree.

The detected yaw offset is returned (shift * 2pi / num_sector,
cpp:414-418) and — unlike the reference, which discards it
(laserPosegraphOptimization.cpp:561-562) — used to initialize loop ICP.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from navtech_radar_slam_tpu.config import ScanContextConfig
from navtech_radar_slam_tpu.ops.topk import top_k

#: precision of the all-shift correlation einsums.  HIGHEST (full f32):
#: radar descriptors are sparse occupancy images whose shift distances tie
#: or nearly tie, and TF32 (the GPU default, ~3 decimal digits) reorders
#: near-ties and so changes loop candidates; at (4096, 1200) x (1200, 60)
#: per query the full-f32 product costs next to nothing.
SC_PRECISION = jax.lax.Precision.HIGHEST


def make_scancontext(
    xy: jnp.ndarray,
    z: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: ScanContextConfig,
) -> jnp.ndarray:
    """Feature cloud -> (num_ring, num_sector) descriptor via scatter-max.

    xy: (K, 2) sensor-frame meters; z: (K,) heights (0 for radar features —
    the z + lidar_height lift then yields a 2.0/0.0 occupancy image exactly
    like the reference's radar usage, SURVEY §3.5).

    When cfg.max_desc_features > 0 only the first K slots contribute: the
    pipeline's clouds are emitted in detector-power order (ops/cen2019
    _finalize_topk), so this keeps the strongest, speckle-stable targets and
    drops the weak tail that scrambles the occupancy image (see the config
    field's calibration note).  Callers with unordered clouds should set it
    to 0 or pre-sort."""
    r = jnp.linalg.norm(xy, axis=-1)
    theta = jnp.mod(jnp.arctan2(xy[:, 1], xy[:, 0]), 2.0 * jnp.pi)

    in_range = valid & (r < cfg.max_radius) & (r > 1e-3)
    if 0 < cfg.max_desc_features < xy.shape[0]:
        in_range = in_range & (jnp.arange(xy.shape[0]) < cfg.max_desc_features)
    ring = jnp.clip(
        (r / cfg.max_radius * cfg.num_ring).astype(jnp.int32), 0, cfg.num_ring - 1
    )
    sector = jnp.clip(
        (theta / (2.0 * jnp.pi) * cfg.num_sector).astype(jnp.int32),
        0,
        cfg.num_sector - 1,
    )
    val = jnp.where(in_range, z + cfg.lidar_height, -jnp.inf)

    desc = jnp.full((cfg.num_ring, cfg.num_sector), -jnp.inf, val.dtype)
    desc = desc.at[ring, sector].max(val)
    return jnp.where(jnp.isfinite(desc), desc, 0.0)


def ring_key(desc: jnp.ndarray) -> jnp.ndarray:
    """Rotation-invariant row means (makeRingkeyFromScancontext cpp:198-211)."""
    return jnp.mean(desc, axis=-1)


def sector_key(desc: jnp.ndarray) -> jnp.ndarray:
    """Column means (makeSectorkeyFromScancontext cpp:214-227)."""
    return jnp.mean(desc, axis=-2)


def _normalize_columns(desc: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unit-normalize descriptor columns; returns (normalized, nonzero mask)."""
    norm = jnp.linalg.norm(desc, axis=-2, keepdims=True)
    nz = norm[..., 0, :] > 1e-9
    return desc / jnp.maximum(norm, 1e-9), nz


def sc_shift_distance_matrix(
    query: jnp.ndarray, bank: jnp.ndarray
) -> jnp.ndarray:
    """distDirectSC at EVERY circular column shift, batched over the bank.

    query: (R, S); bank: (N, R, S).  Returns the (N, S) distance matrix
    where entry [n, z] is the reference's distance definition — mean over
    columns (where both columns are non-zero) of (1 - cosine similarity)
    (cpp:69-90) — with the query rolled by z columns."""
    S = query.shape[1]
    qn, qnz = _normalize_columns(query)
    bn, bnz = _normalize_columns(bank)

    # all S rolled copies of the query: (S, R, S); roll by +shift matches
    # the reference's circshift of candidate vs query
    shifts = jnp.arange(S)
    col_idx = jnp.mod(shifts[:, None] + jnp.arange(S)[None, :], S)  # (S, S)
    q_rolled = qn[:, col_idx]                    # (R, S_shift, S_col)
    q_rolled = jnp.moveaxis(q_rolled, 1, 0)      # (S_shift, R, S_col)
    qnz_rolled = qnz[col_idx]                    # (S_shift, S_col)

    # cosine mass: C[n, shift] = sum_cols qn_shifted . bn  -> one matmul
    C = jnp.einsum(
        "zrc,nrc->nz",
        q_rolled,
        bn,
        preferred_element_type=jnp.float32,
        precision=SC_PRECISION,
    )
    counts = jnp.einsum(
        "zc,nc->nz",
        qnz_rolled.astype(jnp.float32),
        bnz.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=SC_PRECISION,
    )
    dist = 1.0 - C / jnp.maximum(counts, 1.0)
    return jnp.where(counts > 0, dist, 1.0)


def sc_distance_all_shifts(
    query: jnp.ndarray, bank: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Best distance over ALL shifts (the reference's vkey-align + ±10%
    search done exhaustively — the whole shift axis is one matmul here).

    Returns (dist (N,), argmin shift (N,))."""
    dist = sc_shift_distance_matrix(query, bank)
    # clamp f32 rounding: a perfect self-match can land at -1e-3
    return jnp.maximum(jnp.min(dist, axis=-1), 0.0), jnp.argmin(dist, axis=-1)


def sc_distance_ratio_shifts(
    query: jnp.ndarray, bank: jnp.ndarray, cfg: ScanContextConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Best distance over the reference's RESTRICTED shift search: align by
    sector key first (fastAlignUsingVkey, cpp:93-113), then search only
    ± num_sector * search_ratio column shifts around that alignment
    (distanceBtnScanContext, cpp:116-148; SEARCH_RATIO h:96).

    The distances themselves come from the same batched all-shift matrix
    (computing the matrix is one matmul — cheaper than a gather of a
    ragged shift window); the restriction is an argmin mask, so the
    RESULT matches the reference's two-stage search exactly."""
    S = query.shape[1]
    dist = sc_shift_distance_matrix(query, bank)           # (N, S)

    # sector-key alignment: argmin_z || roll(vkey_q, z) - vkey_b ||
    # via the correlation expansion (||a||² is shift-invariant)
    vq = sector_key(query)                                  # (S,)
    vb = jax.vmap(sector_key)(bank)                         # (N, S)
    shifts = jnp.arange(S)
    col_idx = jnp.mod(shifts[:, None] + shifts[None, :], S)  # (S_shift, S)
    vq_rolled = vq[col_idx]                                 # (S_shift, S)
    corr = jnp.einsum("zc,nc->nz", vq_rolled, vb,
                      preferred_element_type=jnp.float32)
    align = jnp.argmin(
        jnp.sum(vb * vb, axis=-1)[:, None] - 2.0 * corr, axis=-1
    )                                                       # (N,)

    # SEARCH_RADIUS = round(0.5 * SEARCH_RATIO * num_sector) (cpp:122): ±3
    # column shifts at the 0.1 / 60-sector defaults
    radius = max(1, int(round(0.5 * cfg.search_ratio * S)))
    circ = jnp.abs(jnp.mod(shifts[None, :] - align[:, None] + S // 2, S)
                   - S // 2)                                # (N, S)
    dist = jnp.where(circ <= radius, dist, jnp.inf)
    best_shift = jnp.argmin(dist, axis=-1)
    best_dist = jnp.maximum(jnp.min(dist, axis=-1), 0.0)
    return best_dist, best_shift


def shift_to_yaw(shift: jnp.ndarray, cfg: ScanContextConfig) -> jnp.ndarray:
    """Column shift -> yaw offset (cpp:414-418 convention)."""
    s = shift.astype(jnp.float32)
    s = jnp.where(s > cfg.num_sector / 2, s - cfg.num_sector, s)
    return s * (2.0 * jnp.pi / cfg.num_sector)


def ring_key_candidates(
    query_key: jnp.ndarray, bank_keys: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k nearest ring keys by L2 — the reference's nanoflann KNN
    (cpp:367-374) as a distance matmul.  bank_keys: (N, R)."""
    d2 = jnp.sum((bank_keys - query_key[None, :]) ** 2, axis=-1)
    neg_d2, idx = top_k(-d2, k)
    return idx, -neg_d2


def ringkey_searchable_bound(num_valid, cfg: ScanContextConfig):
    """Upper bound (exclusive) of bank indices the ring-key path may search.

    Combines the recency exclusion (NUM_EXCLUDE_RECENT, h:92) with the
    KD-tree staleness emulation: the reference builds the tree on its FIRST
    detect call (counter 0, cpp:347) — i.e. at keyframe num_exclude_recent+1
    when detection runs per keyframe — and every ``tree_making_period``
    calls after (h:103); between rebuilds the candidate set is frozen at
    the last rebuild's bank.  tree_making_period <= 1 means always fresh."""
    bound = num_valid - cfg.num_exclude_recent
    if cfg.tree_making_period > 1:
        p = cfg.tree_making_period
        e1 = cfg.num_exclude_recent + 1
        v_last = e1 + (jnp.maximum(num_valid - e1, 0) // p) * p
        bound = jnp.minimum(bound, v_last - cfg.num_exclude_recent)
    return bound


def ringkey_two_stage_best(
    query_desc: jnp.ndarray,
    bank_desc: jnp.ndarray,
    bank_ring_keys: jnp.ndarray,
    searchable: jnp.ndarray,
    k: int,
    cfg: ScanContextConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Core of the reference's two-stage pipeline (cpp:331-422), shared by
    the single-device detector and the sharded per-shard search so their
    candidate-gating semantics can never diverge: ring-key KNN prefilter of
    ``k`` candidates over the ``searchable`` rows (cpp:367-374), then
    shift-correlation scoring on those candidates only (ratio-restricted
    window when cfg.search_ratio > 0, cpp:93-148).

    Returns (best row index into bank_desc, best distance, best shift);
    distance is +inf when no searchable row exists."""
    qkey = ring_key(query_desc)
    d2 = jnp.sum((bank_ring_keys - qkey[None, :]) ** 2, axis=-1)
    d2 = jnp.where(searchable, d2, jnp.inf)
    _, cand = top_k(-d2, k)
    cand_desc = bank_desc[cand]                       # (k, R, S)
    if cfg.search_ratio > 0:
        dist, shift = sc_distance_ratio_shifts(query_desc, cand_desc, cfg)
    else:
        dist, shift = sc_distance_all_shifts(query_desc, cand_desc)
    dist = jnp.where(jnp.isfinite(d2[cand]), dist, jnp.inf)
    j = jnp.argmin(dist)
    return cand[j], dist[j], shift[j]


class LoopCandidate(NamedTuple):
    idx: jnp.ndarray        # () int32 matched keyframe index (-1 if none)
    dist: jnp.ndarray       # () float32 best SC distance
    yaw: jnp.ndarray        # () float32 yaw offset estimate (rad)
    found: jnp.ndarray      # () bool


def detect_loop(
    query_desc: jnp.ndarray,
    bank_desc: jnp.ndarray,
    num_valid: jnp.ndarray,
    cfg: ScanContextConfig,
) -> LoopCandidate:
    """Full-bank loop detection (detectLoopClosureID, cpp:331-422).

    bank_desc: (N_max, R, S) padded descriptor bank; num_valid: () number of
    stored keyframes (the query is assumed to be keyframe num_valid - 1, and
    the most recent num_exclude_recent keyframes are excluded, h:92)."""
    N = bank_desc.shape[0]
    dist, shift = sc_distance_all_shifts(query_desc, bank_desc)
    idx = jnp.arange(N)
    searchable = idx < (num_valid - cfg.num_exclude_recent)
    dist = jnp.where(searchable, dist, jnp.inf)
    best = jnp.argmin(dist)
    best_dist = dist[best]
    found = best_dist < cfg.sc_dist_thres
    return LoopCandidate(
        idx=jnp.where(found, best, -1).astype(jnp.int32),
        dist=best_dist,
        yaw=shift_to_yaw(shift[best], cfg),
        found=found,
    )


def detect_loop_ringkey(
    query_desc: jnp.ndarray,
    bank_desc: jnp.ndarray,
    bank_ring_keys: jnp.ndarray,
    num_valid: jnp.ndarray,
    cfg: ScanContextConfig,
) -> LoopCandidate:
    """Two-stage parity path: ring-key KNN prefilter (k = num_candidates)
    then shift-distance on candidates only — the reference's exact pipeline
    (cpp:331-422), useful when the bank is sharded and the full correlation
    would cross hosts.

    Two reference-staleness knobs are honored here (and deliberately NOT in
    the always-fresh, exhaustive "full" mode):

      * ``tree_making_period``: the reference rebuilds its KD-tree every 30
        inserts (h:103, cpp:347-360), so between rebuilds the candidate set
        is stale.  Here the searchable bank is quantized to the largest
        multiple of the period <= num_valid — the same <= period-insert
        staleness bound on a deterministic (keyframe-count) schedule.
      * ``search_ratio``: per-candidate column shifts are restricted to the
        sector-key-aligned window (sc_distance_ratio_shifts, cpp:93-148)
        instead of searched exhaustively."""
    N = bank_desc.shape[0]
    searchable = jnp.arange(N) < ringkey_searchable_bound(num_valid, cfg)
    best, best_dist, best_shift = ringkey_two_stage_best(
        query_desc, bank_desc, bank_ring_keys, searchable,
        cfg.num_candidates, cfg,
    )
    found = best_dist < cfg.sc_dist_thres
    return LoopCandidate(
        idx=jnp.where(found, best, -1).astype(jnp.int32),
        dist=best_dist,
        yaw=shift_to_yaw(best_shift, cfg),
        found=found,
    )


class ScanContextManager:
    """Host-side bank manager mirroring the reference's SCManager API
    (Scancontext.h:57-122) over the batched device ops.

    Method names follow the reference for drop-in familiarity; internally
    the bank is one padded device array and every query is a single
    correlation matmul (or the ring-key two-stage path)."""

    def __init__(self, cfg: ScanContextConfig, capacity: int = 4096):
        self.cfg = cfg
        self.capacity = capacity
        self.bank = jnp.zeros((capacity, cfg.num_ring, cfg.num_sector),
                              jnp.float32)
        self.ring_keys = jnp.zeros((capacity, cfg.num_ring), jnp.float32)
        self.num = 0

    def setSCdistThres(self, thres: float) -> None:  # noqa: N802 (parity)
        import dataclasses

        self.cfg = dataclasses.replace(self.cfg, sc_dist_thres=thres)

    def makeAndSaveScancontextAndKeys(self, xy, z=None, valid=None):  # noqa: N802
        """cpp:249-260 — build descriptor + keys and append to the bank."""
        K = xy.shape[0]
        z = jnp.zeros(K) if z is None else z
        valid = jnp.ones(K, bool) if valid is None else valid
        if self.num >= self.capacity:
            raise RuntimeError("ScanContext bank capacity exceeded")
        desc = make_scancontext(xy, z, valid, self.cfg)
        self.bank = self.bank.at[self.num].set(desc)
        self.ring_keys = self.ring_keys.at[self.num].set(ring_key(desc))
        self.num += 1
        return desc

    def detectLoopClosureID(self) -> Tuple[int, float]:  # noqa: N802
        """cpp:331-422 — query the newest descriptor against the bank.
        Returns (index, yaw) with index -1 when no loop (reference
        convention)."""
        if self.num == 0:
            return -1, 0.0
        query = self.bank[self.num - 1]
        if self.cfg.search_mode == "ringkey":
            res = detect_loop_ringkey(
                query, self.bank, self.ring_keys,
                jnp.asarray(self.num), self.cfg,
            )
        else:
            res = detect_loop(query, self.bank, jnp.asarray(self.num), self.cfg)
        return int(res.idx), float(res.yaw)

    def saveScancontextAndKeys(self, desc) -> None:  # noqa: N802
        """cpp:236-246 — append an externally built descriptor."""
        if self.num >= self.capacity:
            raise RuntimeError("ScanContext bank capacity exceeded")
        desc = jnp.asarray(desc)
        self.bank = self.bank.at[self.num].set(desc)
        self.ring_keys = self.ring_keys.at[self.num].set(ring_key(desc))
        self.num += 1

    def detectLoopClosureIDBetweenSession(self, query_desc) -> Tuple[int, float]:  # noqa: N802
        """cpp:267-328 — query an external descriptor against this bank."""
        res = detect_loop_between_sessions(
            jnp.asarray(query_desc), self.bank, jnp.asarray(self.num), self.cfg
        )
        return int(res.idx), float(res.yaw)


# -- multi-session API (parity with saveScancontextAndKeys /
#    detectLoopClosureIDBetweenSession, cpp:236-246, 267-328) --------------

def detect_loop_between_sessions(
    query_desc: jnp.ndarray,
    other_bank_desc: jnp.ndarray,
    other_num_valid: jnp.ndarray,
    cfg: ScanContextConfig,
) -> LoopCandidate:
    """Query one session's descriptor against another session's full bank
    (no recency exclusion — sessions are distinct trajectories)."""
    N = other_bank_desc.shape[0]
    dist, shift = sc_distance_all_shifts(query_desc, other_bank_desc)
    searchable = jnp.arange(N) < other_num_valid
    dist = jnp.where(searchable, dist, jnp.inf)
    best = jnp.argmin(dist)
    best_dist = dist[best]
    found = best_dist < cfg.sc_dist_thres
    return LoopCandidate(
        idx=jnp.where(found, best, -1).astype(jnp.int32),
        dist=best_dist,
        yaw=shift_to_yaw(shift[best], cfg),
        found=found,
    )

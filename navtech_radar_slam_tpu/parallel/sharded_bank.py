"""Mesh-sharded ScanContext descriptor bank search.

The BASELINE.json north star: loop-candidate search cost must stay flat as
the bank grows by scaling chips/hosts.  The bank (N, R, S) shards along the
keyframe axis; query descriptors are replicated; each shard searches its
slice and the global best is reduced with one tiny all_gather — the
reference's KD-tree + per-candidate loop (Scancontext.cpp:331-422) becomes
  shard-local correlation matmul  +  O(devices) gather.

Two shard-local search modes, following ScanContextConfig.search_mode:

  * "full": the batched all-shift correlation over the whole local slice
    (ops/scancontext.sc_distance_all_shifts) — the default;
  * "ringkey": the reference's two-stage pipeline done shard-locally —
    ring-key KNN prefilter (cpp:367-374) selects this shard's
    ``shard_top_k`` best candidates (ParallelConfig.shard_top_k), then the
    shift-correlation runs only on those; the global candidate set is the
    union over shards.  Honors the search_ratio shift window and the
    tree_making_period staleness bound exactly like the single-device
    ring-key path (ops/scancontext.detect_loop_ringkey).

Both the single-query detector (per-keyframe path) and the batched
multi-query detector (the fused-segment streaming path, one dispatch for a
whole segment's queries) are provided; the batched form vmaps only the
query side — the bank side stays sharded, so per-query cost is flat in the
bank size regardless of batch width.
"""

from __future__ import annotations

import functools


import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from navtech_radar_slam_tpu.config import ScanContextConfig
from navtech_radar_slam_tpu.ops import scancontext as sc_ops
from navtech_radar_slam_tpu.parallel.mesh import BANK_AXIS


def _local_best_one(query, bank_shard, rkeys_local, gidx, num_valid,
                    cfg: ScanContextConfig, shard_top_k: int):
    """This shard's best (dist, global idx, shift) for ONE query."""
    if cfg.search_mode == "ringkey":
        # the two-stage prefilter+score core is SHARED with the
        # single-device detect_loop_ringkey (ops/scancontext.py) so the
        # candidate-gating semantics cannot diverge between paths; only
        # the searchable mask (global-index bound on this shard's rows)
        # and the prefilter width differ
        searchable = gidx < sc_ops.ringkey_searchable_bound(num_valid, cfg)
        best, dist, shift = sc_ops.ringkey_two_stage_best(
            query, bank_shard, rkeys_local, searchable,
            min(shard_top_k, bank_shard.shape[0]), cfg,
        )
        return jnp.stack([
            dist,
            gidx[best].astype(jnp.float32),
            shift.astype(jnp.float32),
        ])

    dist, shift = sc_ops.sc_distance_all_shifts(query, bank_shard)
    searchable = gidx < (num_valid - cfg.num_exclude_recent)
    dist = jnp.where(searchable, dist, jnp.inf)
    j = jnp.argmin(dist)
    return jnp.stack(
        [dist[j], gidx[j].astype(jnp.float32), shift[j].astype(jnp.float32)]
    )


def _local_search(
    queries: jnp.ndarray,
    bank_shard: jnp.ndarray,
    num_valids: jnp.ndarray,
    cfg: ScanContextConfig,
    axis: str,
    shard_top_k: int,
):
    """Per-shard best candidates for a (T,) batch of queries; returns the
    replicated global best per query, (T, 3).

    Runs inside shard_map: bank_shard is this device's (N/d, R, S) slice.
    The ring keys for the ringkey prefilter are row means of the local
    slice — recomputed per call (a (N/d, R, S) mean is noise next to the
    correlation) so the bank array stays the only sharded state."""
    n_local = bank_shard.shape[0]
    shard_id = jax.lax.axis_index(axis)
    gidx = shard_id * n_local + jnp.arange(n_local)
    rkeys_local = (jax.vmap(sc_ops.ring_key)(bank_shard)
                   if cfg.search_mode == "ringkey" else None)

    local = jax.vmap(
        lambda q, nv: _local_best_one(q, bank_shard, rkeys_local, gidx, nv,
                                      cfg, shard_top_k)
    )(queries, num_valids)                             # (T, 3)

    allbest = jax.lax.all_gather(local, axis)          # (d, T, 3) replicated
    k = jnp.argmin(allbest[:, :, 0], axis=0)           # (T,)
    return jnp.take_along_axis(allbest, k[None, :, None], axis=0)[0]


def _to_candidate(best, cfg: ScanContextConfig) -> sc_ops.LoopCandidate:
    best_dist = best[..., 0]
    found = best_dist < cfg.sc_dist_thres
    idx = best[..., 1].astype(jnp.int32)
    return sc_ops.LoopCandidate(
        idx=jnp.where(found, idx, -1),
        dist=best_dist,
        yaw=sc_ops.shift_to_yaw(best[..., 2].astype(jnp.int32), cfg),
        found=found,
    )


def _make_search(mesh: Mesh, cfg: ScanContextConfig, axis: str,
                 shard_top_k: int):
    return shard_map(
        functools.partial(_local_search, cfg=cfg, axis=axis,
                          shard_top_k=shard_top_k),
        mesh=mesh,
        in_specs=(P(), P(axis), P()),
        out_specs=P(),
        check_vma=False,
    )


def make_sharded_loop_detector(mesh: Mesh, cfg: ScanContextConfig,
                               axis: str = BANK_AXIS, shard_top_k: int = 4):
    """Returns jitted (query (R,S), bank (N,R,S) sharded, num_valid ()) ->
    LoopCandidate with the same semantics as ops.scancontext.detect_loop
    (or detect_loop_ringkey when cfg.search_mode == "ringkey", with the
    per-shard prefilter width ``shard_top_k``)."""

    fn = _make_search(mesh, cfg, axis, shard_top_k)

    def detect(query, bank, num_valid):
        best = fn(query[None], bank, num_valid[None])[0]
        return _to_candidate(best, cfg)

    return jax.jit(detect)


def make_sharded_loop_detector_batch(mesh: Mesh, cfg: ScanContextConfig,
                                     axis: str = BANK_AXIS,
                                     shard_top_k: int = 4):
    """Batched variant: (queries (T,R,S), bank sharded, num_valids (T,)) ->
    LoopCandidate with (T,) leaves — ONE dispatch searches a whole fused
    segment's queries against the sharded bank (the mesh engine's streaming
    fast path; the per-slot num_valids bound reproduces the sequential
    insert/search interleaving exactly as _make_kf_segment does)."""

    fn = _make_search(mesh, cfg, axis, shard_top_k)

    def detect(queries, bank, num_valids):
        best = fn(queries, bank, num_valids)
        return _to_candidate(best, cfg)

    return jax.jit(detect)

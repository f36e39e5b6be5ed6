"""Dense-template batched save_kmers scanner (device path of savekmers.c:2442).

The scan keeps a DENSE [batch, DB_size] score state, exactly mirroring
the reference's per-template Score/extendScore/include arrays
(savekmers.c:2442-3065), vectorised over the batch:

1. k-mer windows -> hash lookup returning a value-LIST id per window
   (the index's deduplicated template lists),
2. run compaction: consecutive windows with the same list id form a run;
   per-run aggregates (start, end, in-run score) come from prefix sums,
3. a loop over run slots updates the dense per-template state: members
   of run r get the run score plus either the k*M opening (first sight)
   or the reconnect score over the gap since their own last hit -- the
   reference's flush logic (savekmers.c:2573-2625), one run at a time,
   all templates in parallel.  Membership tests read a bit-packed
   [n_lists, DB_size/32] table.  On the GPU the loop is one kernel
   (ops/scan_kernel.py); on the CPU it is the plain XLA loop below,
4. tie-lists are extracted with top_k over first-seen keys and packed --
   together with the fw/rc merge decision (savekmers.c:2766-2833) -- into
   a compact per-batch stream on device, so the host receives a few ids
   per read instead of [batch, DB_size] state.

No bit-packed attribute words are needed, so arbitrarily long reads
(Nanopore) run on device.

Dense state is O(batch * DB_size); the scanner is used when the membership
table fits the per-device budget (gene panels up to ~100k templates) --
or, over-budget but multi-device, with the template columns sharded over
a ('db',) device mesh (spltdb.c:625 / shm.c:466-476 roles).  Still-larger
DBs keep the pair-stream scanner (scan_fast.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.format import KmaIndex
from .device_index import (MURMUR_SEED2, _cuckoo_build, batch_kmers,
                           murmur32, murmur32_np, valid_windows)
from .scan_common import (_reconnect_score, _run_transition_score,
                          _segment_starts, ScanParams)

# host scalar: np constants embed in the program for free, device-array
# constants would be fetched back at lowering time
BIG = np.int32(0x3FFFFFFF)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dense_budget_bytes() -> int:
    """Per-device budget for the dense membership image: an eighth of
    the memory the device reports (the [batch, DB] scan state and the
    compiled programs take the rest).  A device that reports no limit
    (the CPU) is budgeted from the host's physical memory."""
    import os
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        limit = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return int(limit) // 8


@dataclasses.dataclass
class DenseIndex:
    """Device image of a frozen DB for the dense scanner.

    The hash payload is the value-LIST id (dense row); `bits[list_id]`
    is the bit-packed template membership of that list.  Tie ordering
    needs no position table because the reference's value lists are
    ascending template id (templates are indexed in id order), so the
    append order is (first-including run, template id).
    """

    kmersize: int
    mlen: int
    flag: int
    db_size: int
    t_pad: int                  # padded template axis (multiple of 128)
    n_lists: int
    mega: bool
    size: int                   # cuckoo half size or mega mask+1
    max_probe: int              # 0 = cuckoo, >0 = open-table probe unroll
    max_list: int
    exist: jax.Array            # mega: [size] i32 list id or -1
    kv: jax.Array               # cuckoo/open: [slots, 2] (key, list id|-1)
    bits: jax.Array             # [n_lists, t_pad//32] u32 membership bits
    list_voff: np.ndarray       # host: list id -> values offset
    sharded: bool = False       # membership columns split over a ('db',)
                                # device mesh (over-HBM DBs)

    @classmethod
    def from_host(cls, idx: KmaIndex, mem_budget_bytes: int = None,
                  n_db: int = 1) -> "DenseIndex":
        """Build the device image; ``n_db`` > 1 shards the bit-packed
        template columns over the first n_db devices of a ('db',) mesh
        -- HBM capacity scales with the mesh while the hash tables stay
        replicated (the index under -shm, hashmapkma.c:457-597, with the
        spltDB shard-table role, spltdb.c:625, played by the column
        shards).  The budget is then per DEVICE."""
        if mem_budget_bytes is None:
            mem_budget_bytes = dense_budget_bytes()
        if idx.mlen > 16:
            raise NotImplementedError("dense index requires mlen <= 16")
        if idx.flag & 3:
            raise NotImplementedError(
                "cmer (-m/-hc) DBs use the host scanner")
        values = np.asarray(idx.values, dtype=np.int64)
        # lcm keeps the sharded word axis (t_pad//32) divisible by n_db
        import math
        t_pad = _round_up(idx.db_size + 1,
                          math.lcm(128, 32 * max(n_db, 1)))

        if idx.mega:
            offs = np.unique(idx.exist[idx.exist != idx.null_index]
                             ).astype(np.int64)
        else:
            offs = np.unique(idx.value_index[: idx.n]).astype(np.int64)
        V = len(offs)
        if V * t_pad * 2 > mem_budget_bytes * max(n_db, 1):
            raise NotImplementedError("DB too large for dense membership")
        cnts = values[offs].astype(np.int64)
        max_list = int(cnts.max()) if V else 0
        if max_list > 0x7FFE:
            raise NotImplementedError("value list too long for i16 table")

        # bit-packed membership: the run loop gathers these
        # [t_pad/32]-word rows; in-list ORDER needs no table because the
        # reference's value lists are ascending template id
        total = int(cnts.sum())
        rows_flat = np.repeat(np.arange(V, dtype=np.int64), cnts)
        pos_flat = (np.arange(total, dtype=np.int64)
                    - np.repeat(np.cumsum(cnts) - cnts, cnts))
        tid_flat = values[np.repeat(offs, cnts) + 1 + pos_flat]
        bits = np.zeros((V, t_pad // 32), dtype=np.uint32)
        np.bitwise_or.at(bits, (rows_flat, tid_flat // 32),
                         (np.uint32(1) << (tid_flat % 32).astype(np.uint32)))

        if n_db > 1:
            from jax.sharding import (Mesh, NamedSharding,
                                      PartitionSpec as P)
            mesh = Mesh(np.array(jax.devices()[:n_db]), ("db",))

            def put_rep(a):
                return jax.device_put(a, NamedSharding(mesh, P()))

            def put_col(a):
                return jax.device_put(a, NamedSharding(mesh,
                                                       P(None, "db")))
        else:
            put_rep = put_col = jnp.asarray

        if idx.mega:
            remap = np.full(idx.size, -1, dtype=np.int32)
            live = idx.exist != idx.null_index
            remap[live] = np.searchsorted(offs, idx.exist[live]
                                          ).astype(np.int32)
            return cls(kmersize=idx.kmersize, mlen=idx.mlen, flag=idx.flag,
                       db_size=idx.db_size, t_pad=t_pad, n_lists=V,
                       mega=True, size=idx.size, max_probe=1,
                       max_list=max_list,
                       exist=put_rep(remap),
                       kv=put_rep(np.zeros((1, 2), np.int32)),
                       bits=put_col(bits),
                       list_voff=offs, sharded=n_db > 1)

        keys = idx.key_index[: idx.n].astype(np.uint32)
        rows = np.searchsorted(offs, idx.value_index[: idx.n].astype(np.int64)
                               ).astype(np.int64)
        ck = _cuckoo_build(keys, rows, int(idx.n))
        if ck is None:  # pragma: no cover - cuckoo failure is rare
            raise NotImplementedError("cuckoo build failed for dense index")
        kv, tsize = ck
        return cls(kmersize=idx.kmersize, mlen=idx.mlen, flag=idx.flag,
                   db_size=idx.db_size, t_pad=t_pad, n_lists=V,
                   mega=False, size=tsize, max_probe=0, max_list=max_list,
                   exist=put_rep(np.zeros(1, np.int32)),
                   kv=put_rep(kv),
                   bits=put_col(bits),
                   list_voff=offs, sharded=n_db > 1)


def _lookup_rows(didx_arrays, kmers, *, mega, size, max_probe):
    """list id per k-mer window, or -1 (hashMap_getGlobal semantics)."""
    exist, kv = didx_arrays
    if mega:
        row = exist[(kmers & np.uint32(size - 1)).astype(jnp.int32)]
        return row
    # cuckoo: two gathers
    mask = np.uint32(size - 1)
    km = kmers.astype(jnp.int32)
    b1 = (murmur32(kmers) & mask).astype(jnp.int32)
    b2 = (murmur32(kmers, MURMUR_SEED2) & mask).astype(jnp.int32) \
        + np.int32(size)
    e1 = kv[b1]
    e2 = kv[b2]
    return jnp.where((e1[..., 0] == km) & (e1[..., 1] >= 0), e1[..., 1],
                     jnp.where((e2[..., 0] == km) & (e2[..., 1] >= 0),
                               e2[..., 1], np.int32(-1)))


def _extract_ties(sc, fi, best, inc, p: ScanParams, t_pad,
                  proxi_frac=None):
    """Tie-list extraction shared by the strand and merged epilogues
    (savekmers.c:2750-2833 select): selection mask -> fused-key/
    approx_max_k -> append-ordered template ids.  Returns
    (tids [G, MB], n_best [G], tie_ov [G]).

    Append order = (first-including run, position in that run's value
    list); the reference's lists are ascending template id (templates
    are indexed in id order, updateindex.c:33-77), so the in-list
    position key IS the template id -- no id-table gather needed.  When
    the combined key fits f32's 24-bit mantissa it fuses into the
    approx_max_k value: the final exact top-k returns values sorted
    DESCENDING, i.e. keys ascending -- no second sort."""
    if proxi_frac is None:
        sel = inc & (sc == best[:, None]) & (best[:, None] > 0)
    else:
        thresh = (proxi_frac * best.astype(jnp.float32)
                  ).astype(jnp.int32)  # C double->int truncation
        sel = inc & (sc >= thresh[:, None]) & (best[:, None] > 0)
    n_best = jnp.sum(sel, axis=-1)
    MB = min(p.best_cap, t_pad)
    tie_ov = n_best > MB
    run_span = int(p.run_cap) + 1
    fused = run_span * (t_pad + 1) < (1 << 24)
    if fused:
        key = fi.astype(jnp.int32) * np.int32(t_pad + 1) \
            + jax.lax.broadcasted_iota(jnp.int32, fi.shape, 1)
        negkey = jnp.where(sel, -key, -BIG).astype(jnp.float32)
    else:
        negkey = jnp.where(sel, -fi.astype(jnp.int32), -BIG
                           ).astype(jnp.float32)
    # exact top-k (recall_target=1.0) without a full [G, t_pad] sort
    topv, tids = jax.lax.approx_max_k(negkey, MB, recall_target=1.0)
    topv = topv.astype(jnp.int32)
    cand_ok = topv > -BIG
    if fused:
        tids = jnp.where(cand_ok, tids, 0).astype(jnp.int32)
    else:
        cand_first = jnp.where(cand_ok, -topv, 0)
        key2, tids = jax.lax.sort_key_val(
            jnp.where(cand_ok, cand_first * np.int32(t_pad + 1) + tids,
                      BIG), tids)
        tids = jnp.where(key2 < BIG, tids, 0).astype(jnp.int32)
    return tids, n_best, tie_ov


def _strand_epilogue(score, first, SBIG, p: ScanParams, t_pad, run_ov,
                     proxi_frac=None):
    """Best-score + tie-list extraction shared by the kernel and XLA run
    loops (savekmers.c:2750-2833 select)."""
    inc = first < SBIG
    score = jnp.where(inc, jnp.maximum(score, 0),
                      SBIG * 0)  # savekmers.c:2750-2752
    bestScore = jnp.max(score, axis=-1).astype(jnp.int32)
    tids, n_best, tie_ov = _extract_ties(score, first, bestScore, inc, p,
                                         t_pad, proxi_frac)
    return bestScore, tids, n_best, run_ov, tie_ov, score


def _merged_epilogue(score, first, SBIG, inv, run_ov, p: ScanParams, t_pad,
                     B, k, flat_cap, small_ids, proxi_frac=None):
    """Single-strand-choice epilogue: the fw/rc merge decision
    (savekmers.c:2766-2833) needs only per-strand best scores, so the
    expensive tie top-k runs on the CHOSEN strand's [B, t_pad] rows
    instead of both strands' [2B, t_pad] -- half the extraction cost.
    Equal-best reads (mode 3, needing both strands' lists) are rare and
    are flagged overflow for the dual-strand tier-1 rescan.

    score/first may be in run-count-sorted row order (kernel path);
    `inv` maps original row -> sorted row (None = identity)."""
    inc = first < SBIG
    score_c = jnp.where(inc, jnp.maximum(score, 0), SBIG * 0)
    best_rows = jnp.max(score_c, axis=-1).astype(jnp.int32)
    bestScore = best_rows[inv] if inv is not None else best_rows
    bf, br = bestScore[:B], bestScore[B:]
    some = (bf > 0) | (br > 0)
    usable = (bf >= k) | (br >= k)
    mode = jnp.where(some & usable,
                     jnp.where(bf > br, 1,
                               jnp.where(bf < br, 2, 3)), 0)
    out_score = jnp.where(mode == 2, br, bf)
    out_score = jnp.where(mode == 3, -out_score, out_score) * (mode != 0)

    iota = np.arange(B, dtype=np.int32)
    r0 = jnp.where(mode == 2, iota + np.int32(B), iota)
    rs = inv[r0] if inv is not None else r0
    sc = score_c[rs]                     # [B, t_pad] chosen-strand rows
    fi = first[rs]
    chosen_best = jnp.where(mode == 2, br, bf)
    inc_r = fi < SBIG
    tids, n_best, tie_ov = _extract_ties(sc, fi, chosen_best, inc_r, p,
                                         t_pad, proxi_frac)
    MB = min(p.best_cap, t_pad)
    ov = (run_ov[:B] | run_ov[B:] | (mode == 3)
          | jnp.where(mode == 0, False, tie_ov))
    n_out = jnp.where(ov | (mode == 0), 0, n_best)

    off = jnp.cumsum(n_out) - n_out
    total = jnp.sum(n_out)
    x = np.arange(flat_cap, dtype=np.int32)
    starts = jax.lax.full_like(bestScore, 0, dtype=jnp.int32,
                               shape=(flat_cap,)
                               ).at[off].add(1, mode="drop")
    b = jnp.clip(jnp.cumsum(starts) - 1, 0, B - 1)
    j = x - off[b]
    ids = tids.reshape(-1)[b * MB + jnp.clip(j, 0, MB - 1)]
    dt = jnp.int16 if small_ids else jnp.int32
    flat = jnp.where(x < total, ids, 0).astype(dt)
    meta = jnp.stack(
        [out_score.astype(jnp.int32),
         (mode | (ov.astype(jnp.int32) << 2) | (n_out << 3))], axis=-1)
    return meta, flat


def _dense_strand_scan(codes, lengths, didx_arrays, bits,
                       p: ScanParams, rc_branch, *, mega, size, max_probe,
                       t_pad, n_lists, proxi_frac=None, kernel_mode=None,
                       starts=None, raw_state=False):
    """Both-strands-fused dense save_kmers scan.

    codes [G, L] (G = 2B: fw rows then rc rows), rc_branch [G] bool.
    rc rows may be right-aligned in the padded buffer (device-side RC);
    `starts` bounds their windows from the left.  All scoring is
    position-relative (gaps, reconnects, run order), so the alignment
    offset cancels out.
    Returns (bestScore [G] i32, tids [G, best_cap] i32 front-packed in
    first-seen order, n_best [G], overflow [G]).
    """
    G, L = codes.shape
    k = p.k
    W = L - k + 1
    R = p.run_cap
    kmers = batch_kmers(codes, k)
    valid = valid_windows(codes, lengths, k, starts)

    rows = _lookup_rows(didx_arrays, kmers, mega=mega, size=size,
                        max_probe=max_probe)
    rows = jnp.where(valid, rows, -1)
    hit = rows >= 0

    if not p.exhaustive:
        seg_start = _segment_starts(codes)[:, :W]
        if starts is not None:
            # right-aligned rc rows: the slim H2D format leaves the pad
            # prefix as code 0, so the read start must clamp the segment
            # start for the reference's stride-k probe pattern to align
            seg_start = jnp.maximum(seg_start, starts[:, None])
        probe = valid & (((np.arange(W, dtype=np.int32)[None, :] - seg_start)
                          % k) == 0)
        quick = jnp.any(probe & hit, axis=-1)
        hit = hit & quick[:, None]
        rows = jnp.where(hit, rows, -1)

    posW = np.arange(W, dtype=np.int32)[None, :]
    hit_pos = jnp.where(hit, posW, -1)
    last_hit_le = jax.lax.cummax(hit_pos, axis=1)
    prev_hit = jnp.concatenate(
        [np.full((G, 1), -1, np.int32), last_hit_le[:, :-1]],
        axis=-1)
    has_prev = prev_hit >= 0
    # carry-forward of the last hit's list id (associative select scan)
    rows_fill = jax.lax.associative_scan(
        lambda a, b: jnp.where(b < 0, a, b),
        jnp.where(hit, rows, -1), axis=1)
    rows_prev = jnp.concatenate(
        [np.full((G, 1), -1, np.int32), rows_fill[:, :-1]], axis=-1)
    same_run = hit & has_prev & (rows_prev == rows)
    new_run = hit & ~same_run
    gap = posW - prev_hit - 1
    trans = jnp.where(same_run, _run_transition_score(gap, p), 0
                      ).astype(jnp.int32)

    # compact runs: one [G, R, W] one-hot over the run-count prefix gives
    # every per-run aggregate as a masked reduction
    n_runs = jnp.sum(new_run, axis=-1)
    run_ov = n_runs > R
    run_seg = jnp.cumsum(new_run.astype(jnp.int32), axis=-1)
    rids = np.arange(1, R + 1, dtype=np.int32)[None, :, None]
    seg3 = run_seg[:, None, :]
    in_run = (seg3 == rids) & hit[:, None, :]
    is_start = (seg3 == rids) & new_run[:, None, :]
    posW3 = posW[None, :, :]
    run_valid = rids[:, :, 0] <= n_runs[:, None]
    run_start = jnp.sum(jnp.where(is_start, posW3, 0), axis=-1)
    run_start = jnp.where(run_valid, run_start, BIG)
    run_row = jnp.sum(jnp.where(is_start, rows[:, None, :], 0), axis=-1)
    run_end = jnp.max(jnp.where(in_run, posW3, -1), axis=-1)
    run_score = jnp.sum(jnp.where(in_run, trans[:, None, :], 0), axis=-1)

    # dense per-template state loop over run slots (savekmers.c flushes).
    # GPU: one kernel runs the whole loop with the state in registers
    # (ops/scan_kernel.py); the plain XLA loop below round-trips the state
    # through device memory once per CHUNK of run slots.
    if kernel_mode is not None:
        from ..ops.scan_kernel import GT, run_score_kernel
        # sort strand rows by run count so each GT-row tile's loop bound
        # is its rows' ACTUAL work: n_runs is heavy-tailed (p50=1, ~half
        # the rows have zero runs) and the per-tile max over random rows
        # pays ~p90 iterations for every row.  Epilogue outputs are
        # unpermuted (cheap [G, best_cap] row gathers vs [G, t_pad] state).
        order = jnp.argsort(n_runs).astype(jnp.int32)
        inv = jnp.argsort(order).astype(jnp.int32)
        n_runs_s = n_runs[order]
        rc_s = (jnp.asarray(rc_branch, jnp.int32)
                if isinstance(rc_branch, np.ndarray)
                else rc_branch.astype(jnp.int32))[order]
        # ascending sort: the tile max is its last row
        rmax_tile = jnp.minimum(n_runs_s.reshape(G // GT, GT)[:, -1],
                                R).astype(jnp.int32)
        score, first = run_score_kernel(
            bits, run_row[order].astype(jnp.int32),
            run_start[order].astype(jnp.int32),
            run_end[order].astype(jnp.int32),
            run_score[order].astype(jnp.int32),
            run_valid[order].astype(jnp.int32), rc_s, rmax_tile,
            sparams=(p.k, p.mlen, p.M, p.MM, p.U, p.W1),
            interpret=kernel_mode == "interpret")
        SBIG = np.int32(BIG)
        if raw_state:
            return score, first, inv, run_ov, SBIG
        bestScore, tids, n_best, _, tie_ov, _ = _strand_epilogue(
            score, first, SBIG, p, t_pad, run_ov, proxi_frac=proxi_frac)
        return (bestScore[inv], tids[inv], n_best[inv], run_ov,
                tie_ov[inv], None)
    kM = np.int32(k * p.M)
    rc_col = rc_branch[:, None]
    shifts = np.arange(32, dtype=np.uint32)[None, None, :]
    CHUNK = 8
    pmax = max(abs(p.M), abs(p.MM), abs(p.U), abs(p.W1))
    small_state = (W + k + 2) * pmax * 4 < 32000
    sdt = jnp.int16 if small_state else jnp.int32
    SBIG = np.int16(0x7FFF) if small_state else np.int32(BIG)

    def chunk_body(c, state):
        score, ext, first = state
        for j in range(CHUNK):
            r = c * CHUNK + j
            rr = jnp.minimum(r, R - 1)
            act = run_valid[:, rr] & (r < R)
            rows = bits[run_row[:, rr]]          # [G, w32] u32 row gather
            memb = ((rows[:, :, None] >> shifts) & np.uint32(1)
                    ).reshape(G, t_pad)
            inc = first < SBIG
            ism = act[:, None] & (memb != 0)
            g = (run_start[:, rr, None] - 1) - ext.astype(jnp.int32)
            add = jnp.where(inc, _reconnect_score(g, p, rc_col), kM)
            contrib = (run_score[:, rr, None] + add).astype(sdt)
            score = jnp.where(ism, score + contrib, score)
            first = jnp.where(ism & ~inc, r.astype(sdt), first)
            ext = jnp.where(ism, run_end[:, rr, None].astype(sdt), ext)
        return score, ext, first

    # traced fulls: trace-time jnp.zeros would materialize [G, t_pad]
    # constants and fetch them back during lowering
    zstate = jax.lax.full_like(lengths, 0, dtype=sdt, shape=(G, t_pad))
    init = (zstate, zstate,
            jax.lax.full_like(lengths, int(SBIG), dtype=sdt,
                              shape=(G, t_pad)))
    # loop only to the batch's actual max run count (traced bound)
    r_max = jnp.minimum(jnp.max(n_runs), R).astype(jnp.int32)
    n_chunks = (r_max + CHUNK - 1) // CHUNK
    score, ext, first = jax.lax.fori_loop(0, n_chunks, chunk_body, init)
    if raw_state:
        return score, first, None, run_ov, SBIG
    return _strand_epilogue(score, first, SBIG, p, t_pad, run_ov,
                            proxi_frac=proxi_frac)


def _emit_pack(bestScore, tids, n_best, run_ov, tie_ov, B, k, flat_cap,
               small_ids):
    """fw/rc merge decision + compact packing (savekmers.c:2766-2833;
    the SaveKmersScanner.scan() merge).

    Returns meta [B, 2] i32 (col0 = signed rc_flag score; col1 =
    mode | overflow<<2 | n_out<<3) and flat [flat_cap] signed template ids
    (mode 3 appends rc ids negated)."""
    bf, br = bestScore[:B], bestScore[B:]
    tf, tr = tids[:B], tids[B:]
    nf, nr = n_best[:B], n_best[B:]
    MB = tf.shape[1]

    some = (bf > 0) | (br > 0)
    usable = (bf >= k) | (br >= k)
    mode = jnp.where(some & usable,
                     jnp.where(bf > br, 1,
                               jnp.where(bf < br, 2, 3)), 0)
    score = jnp.where(mode == 2, br, bf)
    score = jnp.where(mode == 3, -score, score) * (mode != 0)

    # run overflow corrupts scores (runs beyond the cap never scored) so
    # it always propagates; tie overflow only truncates the id list, so
    # it matters only for the strand(s) the merge decision emits
    tof, tor = tie_ov[:B], tie_ov[B:]
    ov = (run_ov[:B] | run_ov[B:]
          | jnp.where(mode == 1, tof,
                      jnp.where(mode == 2, tor,
                                jnp.where(mode == 3, tof | tor, False))))

    first = jnp.where((mode == 2)[:, None], tr, tf)
    n1 = jnp.where(ov, 0, jnp.where(mode == 2, nr,
                                    jnp.where(mode == 0, 0, nf)))
    n2 = jnp.where(ov, 0, jnp.where(mode == 3, nr, 0))
    n_out = n1 + n2

    # pack [first[:n1], -tr[:n2]] contiguously by GATHERING from the
    # output side: a B-point scatter of ones at each row's start offset
    # + a cumsum assigns every flat slot its owner row, then four
    # [flat_cap] point gathers fetch the ids (no [B, 2MB] sort and no
    # windowed scatter).
    off = jnp.cumsum(n_out) - n_out
    total = jnp.sum(n_out)
    x = np.arange(flat_cap, dtype=np.int32)
    starts = jax.lax.full_like(bestScore, 0, dtype=jnp.int32,
                               shape=(flat_cap,)
                               ).at[off].add(1, mode="drop")
    b = jnp.clip(jnp.cumsum(starts) - 1, 0, B - 1)
    j = x - off[b]
    n1b = n1[b]
    idf = first.reshape(-1)[b * MB + jnp.clip(j, 0, MB - 1)]
    idr = tr.reshape(-1)[b * MB + jnp.clip(j - n1b, 0, MB - 1)]
    dt = jnp.int16 if small_ids else jnp.int32
    flat = jnp.where(x < total,
                     jnp.where(j < n1b, idf, -idr), 0).astype(dt)
    meta = jnp.stack(
        [score.astype(jnp.int32),
         (mode | (ov.astype(jnp.int32) << 2) | (n_out << 3))], axis=-1)
    return meta, flat


@partial(jax.jit,
         static_argnames=("sparams", "B", "flat_cap", "small_ids", "mega",
                          "size", "max_probe", "t_pad", "n_lists",
                          "proxi_frac", "kernel_mode", "merged"))
def dense_scan_device(codes, lengths, exist, kv, bits, *, sparams,
                      B, flat_cap, small_ids, mega, size, max_probe,
                      t_pad, n_lists, proxi_frac=None, kernel_mode=None,
                      merged=False):
    """codes is the FORWARD batch [B, L]; the reverse complement is built
    on device with lax.rev (right-aligned in the padded buffer -- the
    scan only ever uses relative positions, so no per-row re-alignment
    shift is needed) and the host sends half the bytes.

    merged=True uses the single-strand-choice epilogue (_merged_epilogue)
    -- half the tie-extraction cost; equal-best (mode 3) reads come back
    flagged overflow for the merged=False tier-1 rescan."""
    p = ScanParams(*sparams)
    G = codes.shape[0]
    L = codes.shape[1]
    rc = jnp.flip(jnp.where(codes < 4, 3 - codes, codes), axis=-1)
    codes2 = jnp.concatenate([codes, rc], axis=0)
    lens2 = jnp.concatenate(
        [lengths, jax.lax.full_like(lengths, L)], axis=0)
    starts2 = jnp.concatenate(
        [jax.lax.full_like(lengths, 0), np.int32(L) - lengths], axis=0)
    rc_rowsg = np.arange(2 * G, dtype=np.int32) >= G
    if merged:
        score, first, inv, run_ov, SBIG = _dense_strand_scan(
            codes2, lens2, (exist, kv), bits, p, rc_rowsg,
            mega=mega, size=size, max_probe=max_probe, t_pad=t_pad,
            n_lists=n_lists, proxi_frac=proxi_frac,
            kernel_mode=kernel_mode, starts=starts2, raw_state=True)
        return _merged_epilogue(score, first, SBIG, inv, run_ov, p, t_pad,
                                G, p.k, flat_cap, small_ids,
                                proxi_frac=proxi_frac)
    bestScore, tids, n_best, run_ov, tie_ov, _ = _dense_strand_scan(
        codes2, lens2, (exist, kv), bits, p, rc_rowsg,
        mega=mega, size=size, max_probe=max_probe, t_pad=t_pad,
        n_lists=n_lists, proxi_frac=proxi_frac, kernel_mode=kernel_mode,
        starts=starts2)
    return _emit_pack(bestScore, tids, n_best, run_ov, tie_ov, G, p.k,
                      flat_cap, small_ids)


@partial(jax.jit, static_argnames=("L",))
def unpack_2bit(packed, n_mask, *, L):
    """[B, ceil(L/16)] u32 2-bit words + [B, ceil(L/32)] u32 N bitmask ->
    [B, L] u8 codes (N restored as code 4).  Fixed shapes per (B, L) so
    the per-batch N count never triggers a recompile."""
    pos = np.arange(L, dtype=np.int32)
    word = packed[:, pos // 16]
    codes = ((word >> (2 * (pos % 16)).astype(np.uint32)) & 3
             ).astype(jnp.uint8)
    nw = n_mask[:, pos // 32]
    is_n = ((nw >> (pos % 32).astype(np.uint32)) & 1) != 0
    return jnp.where(is_n, jnp.uint8(4), codes)


def fuse_h2d_host(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """One [B, W2+W32+1] u32 buffer per batch: packed 2-bit words ++
    N-bitmask words ++ length (one host-to-device transfer, not three)."""
    packed, n_mask = pack_2bit_host(codes)
    return np.concatenate(
        [packed, n_mask, lengths[:, None].astype(np.uint32)], axis=1)


@partial(jax.jit, static_argnames=("L",))
def unfuse_h2d(buf, *, L):
    """Split the fused H2D buffer back into (codes [B, L] u8, lengths)."""
    W2 = _round_up(L, 32) // 16
    W32 = _round_up(L, 32) // 32
    codes = unpack_2bit(buf[:, :W2], buf[:, W2: W2 + W32], L=L)
    return codes, buf[:, W2 + W32].astype(jnp.int32)


N_CAP = 2048  # slim-format sparse-N budget per batch


def fuse_slim_host(codes: np.ndarray, lengths: np.ndarray):
    """Slim H2D format: [B, W2+1] u32 (2-bit words ++ length) plus a
    fixed [N_CAP, 2] (row, pos) list of in-read N positions -- the usual
    case of few-or-no Ns ships ~40% fewer bytes than the full bitmask.
    Returns None when the batch exceeds N_CAP (caller falls back to the
    bitmask format).  Pad tails/prefixes carry no N marking; window
    validity comes from lengths/starts instead."""
    B, L = codes.shape
    packed, _ = pack_2bit_host(codes)
    buf = np.concatenate([packed, lengths[:, None].astype(np.uint32)],
                         axis=1)
    in_read = (codes >= 4) & (np.arange(L)[None, :] < lengths[:, None])
    rows, poss = np.nonzero(in_read)
    if len(rows) > N_CAP:
        return None
    npos = np.full((N_CAP, 2), B, np.int32)  # row B: dropped by scatter
    npos[: len(rows), 0] = rows
    npos[: len(rows), 1] = poss
    return buf, npos


@partial(jax.jit, static_argnames=("L",))
def unfuse_slim(buf, npos, *, L):
    """Slim-format device unpack: 2-bit words -> codes, then scatter the
    sparse N list (pad entries point at row B and drop)."""
    pos = np.arange(L, dtype=np.int32)
    word = buf[:, pos // 16]
    codes = ((word >> (2 * (pos % 16)).astype(np.uint32)) & 3
             ).astype(jnp.uint8)
    codes = codes.at[npos[:, 0], npos[:, 1]].set(jnp.uint8(4), mode="drop")
    W2 = _round_up(L, 32) // 16
    return codes, buf[:, W2].astype(jnp.int32)


def rc_host(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Host-side per-read reverse complement within the padded buffer
    (the device-side reversal gather lowers to the scalarized path)."""
    L = codes.shape[1]
    idx = lengths[:, None].astype(np.int64) - 1 - np.arange(L)[None, :]
    ok = idx >= 0
    g = np.take_along_axis(codes, np.where(ok, idx, 0), axis=1)
    g = np.where(g < 4, 3 - g, g)
    return np.where(ok, g, np.uint8(4)).astype(np.uint8)


def pack_2bit_host(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side 2-bit packing for the host-to-device copy: [B, L] u8 ->
    ([B, ceil(L/16)] u32 base words, [B, ceil(L/32)] u32 N bitmask)."""
    B, L = codes.shape
    Lp = _round_up(L, 32)
    c = np.zeros((B, Lp), np.uint32)
    c[:, :L] = codes & 3
    c = c.reshape(B, Lp // 16, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    packed = (c << shifts).sum(axis=-1, dtype=np.uint32)
    nm = np.zeros((B, Lp), np.uint32)
    nm[:, :L] = codes >= 4
    nm = nm.reshape(B, Lp // 32, 32)
    nshifts = np.arange(32, dtype=np.uint32)[None, None, :]
    n_mask = (nm << nshifts).sum(axis=-1, dtype=np.uint32)
    return packed, n_mask


class DenseScanner:
    """Production -1t1 scanner: dense device kernel with host fallback.

    scan_reads() takes the whole read set, returns per-read
    (rc_flag_score, mode, templates) with overflow reads marked for the
    host scanner.  All batches are dispatched before the first device
    sync so transfers overlap compute.
    """

    TIERS = ((48, 256), (192, 2048))  # (run_cap, best_cap) per tier

    def __init__(self, idx: KmaIndex, rewards, exhaustive: bool = False,
                 proxi_frac: Optional[float] = None, batch: int = 4096,
                 flat_headroom: int = 24, mem_budget_bytes: int = None,
                 didx: Optional[DenseIndex] = None):
        try:
            # a prebuilt device image may be shared across scanner
            # configs (the devserve daemon serves one image to many
            # penalty/proxi combinations)
            self.didx = didx if didx is not None \
                else DenseIndex.from_host(idx, mem_budget_bytes)
        except NotImplementedError as err:
            # over ONE device's memory budget: shard the membership columns
            # over the whole device mesh before giving up on the dense
            # formulation (spltdb.c:625 DB-shard role)
            if "dense membership" not in str(err) \
                    or len(jax.devices()) < 2:
                raise
            self.didx = DenseIndex.from_host(idx, mem_budget_bytes,
                                             n_db=len(jax.devices()))
            import sys as _sys
            print("# device scanner: dense membership sharded over %d "
                  "devices ('db' axis)" % len(jax.devices()),
                  file=_sys.stderr)
        self.rewards = rewards
        self.exhaustive = exhaustive
        self.proxi_frac = proxi_frac
        self.batch = batch
        # per-read tie-id device-to-host headroom (ids/read);
        # heavier-tie workloads should raise this to keep reads off the
        # slower tier-1 wide rescan
        self.flat_headroom = flat_headroom
        # provably-spill-free wide-rescan row count, rounded down to a
        # power of two so the recursion reuses ONE compiled shape
        MBw = min(self.TIERS[1][1], self.didx.t_pad)
        r = max(1, (1 << 17) // (2 * MBw))
        self._wide_rows = 1 << (r.bit_length() - 1)
        self.small_ids = self.didx.db_size < (1 << 15)
        from ..ops.platform import use_kernels
        # the run-scoring kernel on the GPU, the plain XLA loop on the
        # CPU; tests set "interpret" to run the kernel's own body there.
        # GSPMD cannot partition a pallas_call, so a ('db',)-sharded image
        # keeps the XLA loop, which shards cleanly over the mesh.
        self.kernel_mode = ("compiled" if use_kernels()
                            and not self.didx.sharded else None)
        from ..ops.scan_kernel import GT
        if self.kernel_mode and (2 * batch) % GT:
            raise ValueError("scan batch must be a multiple of %d"
                             % (GT // 2))
        self._sp_cache: dict = {}

    def _sparams(self, L: int, tier: int):
        """ScanParams tuple for a padded read length; run_cap is clamped
        to the maximum possible run count W (every window can start a
        run) so short-read tiers never pay for impossible run counts."""
        ck = (L, tier)
        if ck not in self._sp_cache:
            d = self.didx
            rc_, bc_ = self.TIERS[tier]
            W = L - d.kmersize + 1
            rc_ = max(1, min(rc_, W))
            self._sp_cache[ck] = tuple(dataclasses.astuple(ScanParams(
                k=d.kmersize, mlen=d.mlen, M=self.rewards.M,
                MM=self.rewards.MM, U=self.rewards.U, W1=self.rewards.W1,
                max_list=d.max_list, exhaustive=self.exhaustive,
                max_probe=d.max_probe, run_cap=rc_, pair_cap=0,
                best_cap=bc_, small_ids=self.small_ids)))
        return self._sp_cache[ck]

    def _call(self, codes_j, lens_j, tier: int, flat_cap: int):
        d = self.didx
        if d.sharded:
            # read batches replicate over the mesh (committed single-
            # device arrays would conflict with the column-sharded table)
            from jax.sharding import NamedSharding, PartitionSpec as P
            mesh = d.bits.sharding.mesh
            rep = NamedSharding(mesh, P())
            codes_j = jax.device_put(codes_j, rep)
            lens_j = jax.device_put(lens_j, rep)
        return dense_scan_device(
            codes_j, lens_j, d.exist, d.kv, d.bits,
            sparams=self._sparams(codes_j.shape[1], tier),
            B=codes_j.shape[0], flat_cap=flat_cap,
            small_ids=self.small_ids, mega=d.mega,
            size=d.size, max_probe=d.max_probe, t_pad=d.t_pad,
            n_lists=d.n_lists, proxi_frac=self.proxi_frac,
            kernel_mode=self.kernel_mode, merged=(tier == 0))

    def scan_reads(self, codes: np.ndarray, lengths: np.ndarray):
        """Returns (scores i32 [N], modes u8 [N], tid_lists: list of
        int32 arrays, overflow bool [N]).  mode 0=unmapped 1=fw 2=rc
        3=merged (tids = fw ++ -rc)."""
        return self.scan_resolve(self.scan_dispatch(codes, lengths))

    def scan_dispatch(self, codes: np.ndarray, lengths: np.ndarray):
        """Dispatch the device work for a read set WITHOUT syncing;
        returns an opaque handle for scan_resolve.  Lets a caller (the
        devserve daemon) overlap one request's device compute with its
        neighbours' host work instead of serializing dispatch+sync per
        request."""
        N = codes.shape[0]
        Bt = self.batch
        # tie-id headroom of the device-to-host stream (24 ids/read);
        # reads past the cap are spilled to the wide tier, so this is a
        # transfer-size knob, not a limit
        flat_cap = self.flat_headroom * Bt
        futs = []
        for off in range(0, N, Bt):
            cj = codes[off: off + Bt]
            lj = lengths[off: off + Bt]
            if len(cj) < Bt:
                cj = np.vstack([cj, np.full((Bt - len(cj), codes.shape[1]),
                                            4, codes.dtype)])
                lj = np.concatenate([lj, np.zeros(Bt - len(lj),
                                                  lengths.dtype)])
            slim = fuse_slim_host(cj, lj)
            if slim is not None:
                cj_dev, lj_dev = unfuse_slim(
                    jnp.asarray(slim[0]), jnp.asarray(slim[1]),
                    L=codes.shape[1])
            else:  # N-heavy batch: full-bitmask format
                cj_dev, lj_dev = unfuse_h2d(
                    jnp.asarray(fuse_h2d_host(cj, lj)), L=codes.shape[1])
            futs.append(self._call(cj_dev, lj_dev, 0, flat_cap))
        return (codes, lengths, futs, flat_cap)

    def scan_resolve(self, handle):
        """Sync + post-process a scan_dispatch handle."""
        codes, lengths, futs, flat_cap = handle
        N = codes.shape[0]
        Bt = self.batch
        outs = jax.device_get(futs)

        scores = np.zeros(N, np.int32)
        modes = np.zeros(N, np.uint8)
        over = np.zeros(N, bool)
        tid_lists: list = [None] * N
        retry = []
        for bi, (meta, flat) in enumerate(outs):
            off = bi * Bt
            n = min(Bt, N - off)
            meta = np.asarray(meta)[:n]
            flat = np.asarray(flat, dtype=np.int32)
            score, packedm = meta[:, 0], meta[:, 1]
            mode = packedm & 3
            ov = (packedm >> 2) & 1
            n_out = packedm >> 3
            offs = np.cumsum(n_out) - n_out
            scores[off: off + n] = score
            modes[off: off + n] = mode
            over[off: off + n] = ov.astype(bool)
            # reads whose slice spilled past flat_cap (.at[].set drop
            # mode) are individually retried through the wide tier
            spilled = offs + n_out > flat_cap
            if spilled.any():
                retry.extend(off + np.flatnonzero(spilled))
            # plain-int lists: numpy scalar coercion per read costs ~1us
            # each, ~20 ms per 20k reads
            want = ((mode != 0) & (ov == 0) & ~spilled).tolist()
            o0 = offs.tolist()
            o1 = (offs + n_out).tolist()
            for i in range(n):
                if want[i]:
                    tid_lists[off + i] = flat[o0[i]: o1[i]]
        retry.extend(np.flatnonzero(over))
        if retry:
            retry = np.unique(np.asarray(retry, dtype=np.int64))
            self._rescan_wide(codes, lengths, retry, scores, modes,
                              tid_lists, over)
        return scores, modes, tid_lists, over

    def _rescan_wide(self, codes, lengths, sel, scores, modes, tid_lists,
                     over, rows=512):
        """Tier-2 pass over the overflow tail on compacted sub-batches.

        A rescan chunk can itself spill its flat buffer when many fat-tie
        reads land together (each read may emit up to 2*best_cap ids);
        spilled rows recurse with a row count small enough that the flat
        buffer provably fits the worst case."""
        MB = min(self.TIERS[1][1], self.didx.t_pad)
        worst = rows * 2 * MB
        if worst <= 1 << 17:  # worst case affordable: provably no spill
            flat_cap, final = worst, True
        else:
            flat_cap, final = 64 * rows, False
        spilled_sel = []
        for off in range(0, len(sel), rows):
            s = sel[off: off + rows]
            sub_c = np.full((rows, codes.shape[1]), 4, codes.dtype)
            sub_l = np.zeros(rows, lengths.dtype)
            sub_c[: len(s)] = codes[s]
            sub_l[: len(s)] = lengths[s]
            sub_cd, sub_ld = unfuse_h2d(
                jnp.asarray(fuse_h2d_host(sub_c, sub_l)), L=codes.shape[1])
            meta, flat = jax.device_get(self._call(sub_cd, sub_ld, 1,
                                                   flat_cap))
            meta = np.asarray(meta)[: len(s)]
            flat = np.asarray(flat, dtype=np.int32)
            score, packedm = meta[:, 0], meta[:, 1]
            mode = packedm & 3
            ov = ((packedm >> 2) & 1).astype(bool)
            n_out = packedm >> 3
            offs = np.cumsum(n_out) - n_out
            scores[s] = score
            modes[s] = mode
            over[s] = ov
            spill = offs + n_out > flat_cap
            for i, ri in enumerate(s):
                if spill[i] and not final:
                    spilled_sel.append(ri)
                    continue
                tid_lists[ri] = (flat[offs[i]: offs[i] + n_out[i]]
                                 if mode[i] and not ov[i] else None)
        if spilled_sel:
            self._rescan_wide(codes, lengths,
                              np.asarray(spilled_sel, dtype=np.int64),
                              scores, modes, tid_lists, over,
                              rows=self._wide_rows)

"""Pair-stream batched save_kmers scanner, generation 3 (savekmers.c:2442).

The scanner for databases past the dense scanner's memory budget: its
state scales with (run, template) pairs, not DB size.  It keeps the
pair-stream formulation but:

- replaces every packed-attribute scatter+cummax carry chain with plain
  ``take_along_axis`` gathers -- an order of magnitude less IR, seconds to
  compile, and no static bit budget, so arbitrarily long reads (Nanopore)
  run on device;
- packs the fw/rc merge decision (savekmers.c:2766-2833) and the
  front-packed tie lists into a compact byte stream ON DEVICE, so a
  4096-read batch transfers ~100 KB instead of megabytes.

Stages per strand-fused [2B, L] batch:
1. rolling k-mers + cuckoo/mega hash lookup -> values offset per window,
2. run segmentation by value-list identity via prefix scans
   (a run = the reference's `values == last` streak, savekmers.c:2521),
3. run compaction to R slots (argsort of run starts),
4. expansion to (run, template) pairs: pair slot -> run via a broadcast
   rank-partition, template id by gathering the values array,
5. stable sort of pairs by template id; per-template totals = segmented
   sums (gather the group-leader prefix), reconnect scores from
   neighbour gaps (savekmers.c:2573-2625),
6. best-score ties extracted in first-seen order (the reference's
   bestTemplates append order) by a second sort.

Validated element-exact against mapping.scan.SaveKmersScanner.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Penalties
from ..index.format import KmaIndex
from .device_index import (DeviceIndex, batch_kmers, lookup_voffsets,
                           valid_windows)
from .scan_common import (ScanParams, _reconnect_score,
                          _run_transition_score, _segment_starts, rc_batch)

BIG = np.int32(0x3FFFFFFF)  # host scalar: no device fetch at lowering


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _strand_scan_fast(codes, lengths, lookup_fn, values, p: ScanParams,
                      rc_branch, proxi_frac=None):
    """Both strands fused: codes [G, L], rc_branch [G] bool column.

    Returns (bestScore [G], tids [G, best_cap] front-packed in first-seen
    order, n_best [G], overflow [G])."""
    G, L = codes.shape
    k = p.k
    W = L - k + 1
    R = p.run_cap
    P = p.pair_cap
    MB = p.best_cap

    kmers = batch_kmers(codes, k)
    valid = valid_windows(codes, lengths, k)
    voff = lookup_fn(kmers)
    voff = jnp.where(valid, voff, -1)
    voff = jax.lax.optimization_barrier(voff)
    hit = voff >= 0

    if not p.exhaustive:
        # sparse first-pass probe at every k-th position (savekmers.c:2485)
        seg_start = _segment_starts(codes)[:, :W]
        probe = valid & (((jnp.arange(W)[None, :] - seg_start) % k) == 0)
        quick = jnp.any(probe & hit, axis=-1)
        hit = hit & quick[:, None]
        voff = jnp.where(hit, voff, -1)

    posW = jnp.arange(W)[None, :]
    hit_pos = jnp.where(hit, posW, -1)
    last_hit_le = jax.lax.cummax(hit_pos, axis=1)
    prev_hit = jnp.concatenate(
        [jnp.full((G, 1), -1, last_hit_le.dtype), last_hit_le[:, :-1]],
        axis=-1)
    has_prev = prev_hit >= 0
    voff_prev = jnp.take_along_axis(voff, jnp.where(has_prev, prev_hit, 0),
                                    axis=-1)
    same_run = hit & has_prev & (voff_prev == voff)
    new_run = hit & ~same_run
    gap = posW - prev_hit - 1
    trans = jnp.where(same_run, _run_transition_score(gap, p), 0
                      ).astype(jnp.int32)
    cum_trans = jnp.cumsum(trans, axis=-1)

    # ---- compact runs to R slots --------------------------------------
    n_runs = jnp.sum(new_run, axis=-1)
    R = min(R, W)          # a read has at most W runs
    overflow = n_runs > R
    order = jnp.argsort(jnp.where(new_run, posW, BIG), axis=-1)[:, :R]
    run_start = jnp.take_along_axis(jnp.where(new_run, posW, BIG), order,
                                    axis=-1)               # [G, R]
    run_valid = run_start < BIG
    rs_safe = jnp.where(run_valid, run_start, 0)
    run_voff = jnp.where(run_valid,
                         jnp.take_along_axis(voff, rs_safe, axis=-1), 0)
    nxt = jnp.concatenate(
        [run_start[:, 1:], jnp.full((G, 1), BIG, run_start.dtype)], axis=-1)
    nxt = jnp.where(nxt < BIG, nxt, W)
    run_end = jnp.take_along_axis(last_hit_le, nxt - 1, axis=-1)
    ct_pad = jnp.concatenate([jnp.zeros((G, 1), jnp.int32), cum_trans],
                             axis=-1)
    run_score = (jnp.take_along_axis(ct_pad, nxt, axis=-1)
                 - jnp.take_along_axis(ct_pad, rs_safe, axis=-1))

    # materialize the [G, R] run arrays: without this barrier XLA fuses
    # their producer chains into the [G, P(, R)] consumers below and
    # rematerializes the whole window scan per pair element (measured
    # 300+ ms/batch instead of ~1 ms)
    (run_start, run_valid, run_voff, run_end, run_score) = \
        jax.lax.optimization_barrier(
            (run_start, run_valid, run_voff, run_end, run_score))

    # ---- expand to (run, template) pairs ------------------------------
    cntR = jnp.where(run_valid, values[run_voff], 0).astype(jnp.int32)
    pair_start = jnp.cumsum(cntR, axis=-1) - cntR          # [G, R]
    n_pairs = pair_start[:, -1] + cntR[:, -1]
    overflow = overflow | (n_pairs > P)

    pidx = jnp.arange(P)[None, :]
    pvalid = pidx < jnp.minimum(n_pairs, P)[:, None]
    # pair slot -> run index: scatter a 1 at each live run's first pair
    # (pair_start is strictly increasing over live runs), then cumsum-1;
    # O(G*P) instead of the O(G*P*R) rank broadcast
    live = run_valid & (cntR > 0)
    g_ids = jnp.broadcast_to(jnp.arange(G)[:, None], pair_start.shape)
    starts = jnp.zeros((G, P), jnp.int32).at[
        g_ids, jnp.where(live, pair_start, P)].add(1, mode="drop")
    r_of = jnp.cumsum(starts, axis=-1) - 1                 # [G, P]
    r_of = jnp.clip(r_of, 0, R - 1)
    l_of = pidx - jnp.take_along_axis(pair_start, r_of, axis=-1)
    vo_p = jnp.take_along_axis(run_voff, r_of, axis=-1)
    tid = values[jnp.where(pvalid, vo_p + 1 + l_of, 0)].astype(jnp.int32)
    tid = jnp.where(pvalid, tid, BIG)
    seen_p = (r_of * (p.max_list + 1) + l_of).astype(jnp.int32)
    tid, r_of, seen_p = jax.lax.optimization_barrier((tid, r_of, seen_p))

    # ---- per-template segmented reduction over sorted pairs -----------
    tid_s, r_s, seen_s = jax.lax.sort(
        (tid, r_of.astype(jnp.int32), seen_p),
        dimension=-1, is_stable=True, num_keys=1)
    valid_s = tid_s < BIG
    rs_s = jnp.take_along_axis(run_score, r_s, axis=-1)
    st_s = jnp.take_along_axis(run_start, r_s, axis=-1)
    en_s = jnp.take_along_axis(run_end, r_s, axis=-1)

    first = jnp.concatenate(
        [jnp.ones((G, 1), bool), tid_s[:, 1:] != tid_s[:, :-1]], axis=-1) \
        & valid_s
    last = jnp.concatenate(
        [tid_s[:, 1:] != tid_s[:, :-1], jnp.ones((G, 1), bool)], axis=-1) \
        & valid_s
    prev_end = jnp.concatenate(
        [jnp.zeros((G, 1), en_s.dtype), en_s[:, :-1]], axis=-1)
    rec_gap = (st_s - 1) - prev_end
    add_first = jnp.where(first, k * p.M,
                          _reconnect_score(rec_gap, p, rc_branch[:, None]))
    contrib = jnp.where(valid_s, rs_s + add_first, 0).astype(jnp.int32)
    cum = jnp.cumsum(contrib, axis=-1)
    # index of my group's first pair, carried forward
    lead = jax.lax.cummax(jnp.where(first, pidx, -1), axis=1)
    lead_safe = jnp.maximum(lead, 0)
    group_base = jnp.take_along_axis(cum - contrib, lead_safe, axis=-1)
    group_sum = cum - group_base
    group_score = jnp.maximum(group_sum, 0)   # clamp (savekmers.c:2750)
    group_seen = jnp.take_along_axis(seen_s, lead_safe, axis=-1)

    gscore = jnp.where(last, group_score, -1)
    bestScore = jnp.maximum(jnp.max(gscore, axis=-1), 0)

    if proxi_frac is None:
        is_best = last & (gscore == bestScore[:, None]) \
            & (bestScore[:, None] > 0)
    else:
        thresh = (jnp.float32(proxi_frac)
                  * bestScore.astype(jnp.float32)).astype(jnp.int32)
        is_best = last & (gscore >= thresh[:, None]) \
            & (bestScore[:, None] > 0)
    bkey = jnp.where(is_best, group_seen, BIG)
    bkey_s, btid_s = jax.lax.sort((bkey, tid_s), dimension=-1,
                                  is_stable=True, num_keys=1)
    best_tids = jnp.where(bkey_s[:, :MB] < BIG, btid_s[:, :MB], 0)
    n_best = jnp.sum(is_best, axis=-1)
    overflow = overflow | (n_best > MB)
    return bestScore, best_tids, n_best, overflow


def _emit_pack(bestScore, tids, n_best, overflow, B, k, flat_cap,
               small_ids):
    """fw/rc merge decision + compact packing (savekmers.c:2766-2833).

    meta [B, 2] i32: col0 = rc_flag score (negative = merged strands);
    col1 = mode | overflow<<2 | n_out<<3 with mode 0=none 1=fw 2=rc
    3=merged.  flat [flat_cap] signed ids; mode 3 appends rc ids negated.
    """
    bf, br = bestScore[:B], bestScore[B:]
    tf, tr = tids[:B], tids[B:]
    nf, nr = n_best[:B], n_best[B:]
    ov = overflow[:B] | overflow[B:]
    MB = tf.shape[1]

    some = (bf > 0) | (br > 0)
    usable = (bf >= k) | (br >= k)
    mode = jnp.where(some & usable,
                     jnp.where(bf > br, 1,
                               jnp.where(bf < br, 2, 3)), 0)
    score = jnp.where(mode == 2, br, bf)
    score = jnp.where(mode == 3, -score, score) * (mode != 0)

    first = jnp.where((mode == 2)[:, None], tr, tf)
    n1 = jnp.where(mode == 2, nr, jnp.where(mode == 0, 0, nf))
    n2 = jnp.where(mode == 3, nr, 0)
    n_out = jnp.where(ov, 0, n1 + n2)

    j = jnp.arange(2 * MB)[None, :]
    from_second = j >= n1[:, None]
    idx2 = jnp.clip(j - n1[:, None], 0, MB - 1)
    row = jnp.where(from_second,
                    -jnp.take_along_axis(tr, idx2, axis=-1),
                    jnp.take_along_axis(first, jnp.minimum(j, MB - 1),
                                        axis=-1))
    rvalid = j < n_out[:, None]

    off = jnp.cumsum(n_out) - n_out
    flat_idx = jnp.where(rvalid, off[:, None] + j, flat_cap)
    dt = jnp.int16 if small_ids else jnp.int32
    flat = jnp.zeros(flat_cap, dt).at[flat_idx.reshape(-1)].set(
        row.astype(dt).reshape(-1), mode="drop")
    meta = jnp.stack(
        [score.astype(jnp.int32),
         (mode | (ov.astype(jnp.int32) << 2) | (n_out << 3))], axis=-1)
    return meta, flat


@partial(jax.jit,
         static_argnames=("sparams", "flat_cap", "mega", "size",
                          "max_probe", "null_index", "proxi_frac"))
def fast_scan_device(codes, lengths, exist, kv, values, *, sparams,
                     flat_cap, mega, size, max_probe, null_index,
                     proxi_frac=None):
    p = ScanParams(*sparams)
    B = codes.shape[0]
    both = jnp.concatenate([codes, rc_batch(codes, lengths)], axis=0)
    lens2 = jnp.concatenate([lengths, lengths], axis=0)
    rc_rows = jnp.arange(2 * B) >= B

    def lookup_fn(kmers):
        return lookup_voffsets(exist, kv, kmers, size, max_probe, mega,
                               null_index)

    out = _strand_scan_fast(both, lens2, lookup_fn, values, p, rc_rows,
                            proxi_frac=proxi_frac)
    return _emit_pack(*out, B, p.k, flat_cap, p.small_ids)


@partial(jax.jit, static_argnames=("n", "L"))
def unpack_2bit(packed, n_flat, n_cnt, *, n, L):
    """[B, ceil(L/16)] u32 2-bit words -> [B, L] u8 codes; N (code 4)
    restored at flat positions read*L+pos (2-bit packing quarters the
    host-to-device bytes)."""
    B = packed.shape[0]
    pos = jnp.arange(L)
    word = packed[:, pos // 16]
    codes = ((word >> (2 * (pos % 16)).astype(jnp.uint32)) & 3
             ).astype(jnp.uint8)
    ok = jnp.arange(n) < n_cnt
    tgt = jnp.where(ok, n_flat, B * L)
    return codes.reshape(-1).at[tgt].set(jnp.uint8(4),
                                         mode="drop").reshape(B, L)


def pack_2bit_host(codes: np.ndarray):
    """[B, L] u8 -> ([B, ceil(L/16)] u32, flat N positions i32)."""
    B, L = codes.shape
    Lp = _round_up(L, 16)
    c = np.zeros((B, Lp), np.uint32)
    c[:, :L] = codes & 3
    c = c.reshape(B, Lp // 16, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    packed = (c << shifts).sum(axis=-1, dtype=np.uint32)
    n_flat = np.flatnonzero(codes == 4).astype(np.int32)
    return packed, n_flat


@dataclasses.dataclass
class ScanResult:
    """Per-read scan output of a whole read set.

    mode: 0=unmapped 1=fw 2=rc 3=merged; score is the signed rc_flag
    (ankers.c rc_flag, negative = merged); tids(i) slices the packed
    stream (mode 3: fw ids then negated rc ids); overflow reads must go
    through the host scanner."""

    scores: np.ndarray
    modes: np.ndarray
    n_out: np.ndarray
    offs: np.ndarray
    flat: np.ndarray
    overflow: np.ndarray

    def tids(self, i: int) -> np.ndarray:
        return self.flat[self.offs[i]: self.offs[i] + self.n_out[i]]


class FastScanner:
    """Production -1t1 device scanner with tiered caps.

    All tier-1 batches are dispatched before the first sync so the
    transfers overlap device compute; the overflow tail
    reruns through a wide-cap variant on compacted sub-batches; reads
    overflowing even that are flagged for the host scanner.
    """

    TIERS = ((48, 768, 128), (256, 8192, 2048))  # (run_cap, pair_cap, best_cap)

    def __init__(self, idx: KmaIndex, rewards: Penalties,
                 exhaustive: bool = False,
                 proxi_frac: Optional[float] = None, batch: int = 4096):
        self.didx = DeviceIndex.from_host(idx)
        self.rewards = rewards
        self.exhaustive = exhaustive
        self.proxi_frac = proxi_frac
        self.batch = batch
        d = self.didx
        small = d.db_size < (1 << 15)
        self.small_ids = small
        self.params = [
            tuple(dataclasses.astuple(ScanParams(
                k=d.kmersize, mlen=d.mlen, M=rewards.M, MM=rewards.MM,
                U=rewards.U, W1=rewards.W1, max_list=d.max_list,
                exhaustive=exhaustive, max_probe=d.max_probe,
                run_cap=rc_, pair_cap=pc_, best_cap=bc_, small_ids=small)))
            for rc_, pc_, bc_ in self.TIERS]

    def _call(self, codes_j, lens_j, tier: int, flat_cap: int):
        d = self.didx
        return fast_scan_device(
            codes_j, lens_j, d.exist, d.kv, d.values,
            sparams=self.params[tier], flat_cap=flat_cap, mega=d.mega,
            size=d.size, max_probe=d.max_probe, null_index=d.null_index,
            proxi_frac=self.proxi_frac)

    def _to_device(self, cj, lj):
        packed, n_flat = pack_2bit_host(cj)
        n_cap = _round_up(max(len(n_flat), 1), 128)
        nf = np.full(n_cap, -1, np.int32)
        nf[: len(n_flat)] = n_flat
        cd = unpack_2bit(jnp.asarray(packed), jnp.asarray(nf),
                         jnp.asarray(np.int32(len(n_flat))),
                         n=n_cap, L=cj.shape[1])
        return cd, jnp.asarray(lj)

    def scan_reads(self, codes: np.ndarray, lengths: np.ndarray
                   ) -> ScanResult:
        N = codes.shape[0]
        Bt = self.batch
        flat_cap = 8 * Bt
        futs = []
        for off in range(0, N, Bt):
            cj = codes[off: off + Bt]
            lj = lengths[off: off + Bt]
            if len(cj) < Bt:
                cj = np.vstack([cj, np.zeros((Bt - len(cj), codes.shape[1]),
                                             codes.dtype)])
                lj = np.concatenate([lj, np.zeros(Bt - len(lj),
                                                  lengths.dtype)])
            cd, ld = self._to_device(cj, lj)
            futs.append(self._call(cd, ld, 0, flat_cap))
        outs = jax.device_get(futs)

        scores = np.zeros(N, np.int32)
        modes = np.zeros(N, np.uint8)
        n_out = np.zeros(N, np.int64)
        over = np.zeros(N, bool)
        chunks = []
        retry = []
        for bi, (meta, flat) in enumerate(outs):
            off = bi * Bt
            n = min(Bt, N - off)
            meta = np.asarray(meta)[:n]
            pm = meta[:, 1]
            no = (pm >> 3).astype(np.int64)
            if no.sum() > flat_cap:
                retry.extend(range(off, off + n))
                chunks.append(np.zeros(0, np.int32))
                continue
            scores[off: off + n] = meta[:, 0]
            modes[off: off + n] = pm & 3
            over[off: off + n] = ((pm >> 2) & 1).astype(bool)
            n_out[off: off + n] = no
            chunks.append(np.asarray(flat, np.int32)[: no.sum()])
        flat_all = (np.concatenate(chunks) if chunks
                    else np.zeros(0, np.int32))
        offs = np.cumsum(n_out) - n_out
        res = ScanResult(scores, modes, n_out, offs, flat_all, over)
        retry.extend(np.flatnonzero(over).tolist())
        if retry:
            sel = np.unique(np.asarray(retry, dtype=np.int64))
            self._rescan_wide(codes, lengths, sel, res)
        return res

    def _rescan_wide(self, codes, lengths, sel, res: ScanResult):
        rows = 512
        flat_cap = 64 * rows
        extra = [res.flat]
        base = len(res.flat)
        for off in range(0, len(sel), rows):
            s = sel[off: off + rows]
            sub_c = np.zeros((rows, codes.shape[1]), codes.dtype)
            sub_l = np.zeros(rows, lengths.dtype)
            sub_c[: len(s)] = codes[s]
            sub_l[: len(s)] = lengths[s]
            cd, ld = self._to_device(sub_c, sub_l)
            meta, flat = jax.device_get(self._call(cd, ld, 1, flat_cap))
            meta = np.asarray(meta)[: len(s)]
            flat = np.asarray(flat, np.int32)
            pm = meta[:, 1]
            no = (pm >> 3).astype(np.int64)
            soffs = np.cumsum(no) - no
            res.scores[s] = meta[:, 0]
            res.modes[s] = pm & 3
            res.overflow[s] = ((pm >> 2) & 1).astype(bool)
            res.n_out[s] = no
            res.offs[s] = base + soffs[: len(s)]
            used = int(no[: len(s)].sum())
            extra.append(flat[:used])
            base += used
        res.flat = np.concatenate(extra)

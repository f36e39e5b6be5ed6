"""Step-2 read scanner: the `-1t1` save_kmers path (savekmers.c:2442-3065).

Host-exact reference implementation.  Per read, both strands are scanned
against the frozen k-mer index; hits are grouped into runs of equal
value-list identity and scored with the gap-classification heuristic.  The
best-scoring template set is emitted as an "anker" record (ankers.c:30-50).

The batched device paths (kma_tpu.mapping.scan_dense / scan_fast) reformulate
the identical arithmetic as dense-membership / segmented reductions and are
validated against this module.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import Penalties
from ..index.format import KmaIndex
from ..io.seq import kmer_scan, rc_codes, valid_kmer_mask


@dataclasses.dataclass
class AnkerHit:
    """One anker record (step2 -> step3 wire unit, ankers.c:30-50)."""

    codes: np.ndarray          # read codes as emitted (fw, or rc if flag&16)
    n_positions: np.ndarray    # N positions of emitted orientation
    rc_flag: int               # +/- best score; negative = merged strands
    templates: np.ndarray      # int32, signed ids (negative = rc in merge)
    header: bytes
    flag: int                  # sam flag bits (16 = reverse)
    # HMM slices with seqlen % 32 == 0 carry one garbage word on the wire
    # (tmpQseq.complen = (len>>5)+1, savekmers.c:4846) which the
    # reference's rc_comp rotates to the FRONT of the rc read
    # (compdna.c:250-270 skips the shift).  The scanner precomputes that
    # exact shifted rc here; None = plain reverse complement.
    rc_override: "np.ndarray | None" = None
    # exact wire words for -s2 anker dumps (the HMM slice view includes
    # one word of step-2 buffer residue); None = pack codes fresh
    wire_words: "np.ndarray | None" = None


def _hits_for_codes(idx: KmaIndex, codes: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, v_offsets) of index hits along one strand.

    Position j is the reference's scan index = end index of the k-mer
    (savekmers.c:2516 increments j per window, j = start + k - 1).
    """
    k = idx.kmersize
    kmers = scan_keys(idx, codes)
    valid = valid_kmer_mask(codes, k)
    pos = np.flatnonzero(valid)
    voff = np.empty(len(pos), dtype=np.int64)
    n = 0
    for i, p in enumerate(pos.tolist()):
        v = lookup_voff(idx, int(kmers[p]))
        if v >= 0:
            pos[n] = p + k - 1
            voff[n] = v
            n += 1
    return pos[:n], voff[:n]


def scan_keys(idx: KmaIndex, codes: np.ndarray) -> np.ndarray:
    """Per-window hash keys: plain k-mers, or cmers for -m/-hc DBs
    (getCmer dispatch, stdnuc.c:396-421)."""
    if idx.flag & 3:
        from ..io.seq import cmer_scan
        return cmer_scan(codes, idx.kmersize, idx.mlen, idx.flag)
    return kmer_scan(codes, idx.kmersize)


def lookup_voff(idx: KmaIndex, kmer: int) -> int:
    """values-offset of a k-mer, or -1 (hashMap_getGlobal, hashmapkma.c:149)."""
    if idx.mega:
        pos = int(idx.exist[kmer & idx.mask])
        return -1 if pos == idx.null_index else pos
    smask = idx.size - 1
    from ..index.format import murmur
    kpos = (murmur(kmer) & smask) if idx.flag else (kmer & smask)
    pos = int(idx.exist[kpos])
    if pos == idx.null_index:
        return -1
    key_index = idx.key_index
    while True:
        km = int(key_index[pos])
        if km == kmer:
            return int(idx.value_index[pos])
        h = murmur(km) if idx.flag else km
        if kpos != (h & smask):
            return -1
        pos += 1


def _quick_hit(idx: KmaIndex, codes: np.ndarray) -> bool:
    """Sparse first-pass probe at every k-th position (savekmers.c:2485-2495)."""
    k = idx.kmersize
    kmers = scan_keys(idx, codes)
    valid = valid_kmer_mask(codes, k)
    # enumerate N-segments to mirror the stride walk across segments
    isN = codes == 4
    n = len(codes)
    j = 0
    seg_bounds = np.flatnonzero(isN).tolist() + [n]
    for end in seg_bounds:
        stop = end - k + 1
        while j < stop:
            if valid[j] and lookup_voff(idx, int(kmers[j])) >= 0:
                return True
            j += k
        j = end + 1
    return False


def _gap_reconnect_mm(gaps: int, k: int, M: int, MM: int, U: int, W1: int
                      ) -> Tuple[int, int, int, int]:
    """(Ms_add, MMs_add, Us_add, W1s_add) for the kmersize<gaps case
    (savekmers.c:2536-2557)."""
    g = gaps - (k - 1)
    if g <= 2:
        mm, m = g, 0
    else:
        mm = g // k + (1 if g % k else 0)
        mm = max(2, mm)
        m = min(g - mm, k)
        m = min(m, mm)
    if (W1 + (g - 1) * U) <= (mm * MM + m * M):
        return k + m, mm, 0, 0
    return k, 0, g - 1, 1


def _scan_strand(idx: KmaIndex, codes: np.ndarray, rewards: Penalties,
                 exhaustive: bool, is_rc_branch: bool, Score: np.ndarray,
                 extendScore: np.ndarray, include: np.ndarray,
                 proxi=None) -> Tuple[int, List[int]]:
    """One strand of save_kmers: returns (bestScore, bestTemplates list).

    Score/extendScore/include are DB_size state arrays; left zeroed on exit
    like the reference.  `is_rc_branch` selects the fw/rc variant of the
    reconnect SNP formula (savekmers.c:2597 uses gaps*M+MM forward,
    :2908 uses kmersize*M+MM on the rc branch).
    """
    k = idx.kmersize
    mlen = idx.mlen
    M, MM, U, W1 = rewards.M, rewards.MM, rewards.U, rewards.W1

    if not exhaustive and not _quick_hit(idx, codes):
        return 0, []

    pos, voff = _hits_for_codes(idx, codes)
    if len(pos) == 0:
        return 0, []

    bestTemplates: List[int] = []
    values = idx.values
    last = -1
    last_end = 0
    Ms = MMs = Us = W1s = 0
    HIT = 0

    for i in range(len(pos)):
        j, v = int(pos[i]), int(voff[i])
        gaps = j - (int(pos[i - 1]) if i else j) - 1 if i else 0
        if i and v == last:
            # same value list: accumulate gap-classified run score
            # (savekmers.c:2521-2569)
            if gaps == 0:
                Ms += 1
            elif mlen <= gaps <= k:
                Ms += k
                MMs += 1
            elif k < gaps:
                ms, mms, us, w1s = _gap_reconnect_mm(gaps, k, M, MM, U, W1)
                Ms += ms
                MMs += mms
                Us += us
                W1s += w1s
            elif mlen != k:
                Ms += gaps
                MMs += 1
            else:
                Ms += gaps
                W1s += 1
                Us += (k - gaps)
            HIT = j
        elif i:
            # flush previous run (savekmers.c:2573-2582)
            score = Ms * M + MMs * MM + Us * U + W1s * W1
            cnt = int(values[last])
            for t in values[last + 1: last + 1 + cnt].tolist():
                Score[t] += score
                extendScore[t] = HIT
            HIT = j - 1
            cnt = int(values[v])
            for t in values[v + 1: v + 1 + cnt].tolist():
                if include[t]:
                    g = HIT - extendScore[t]
                    if g == 0:
                        s = M
                    elif mlen <= g <= k:
                        s = (k * M + MM) if is_rc_branch else (g * M + MM)
                    elif k < g:
                        ms, mms, us, w1s = _gap_reconnect_mm(g, k, M, MM, U, W1)
                        s = k * M + ms_score(ms - k, mms, us, w1s, M, MM, U, W1)
                    elif mlen != k:
                        s = g * M + MM
                    else:
                        s = g * M + (k - g) * U + W1
                    Score[t] += s
                else:
                    Score[t] = k * M
                    include[t] = 1
                    bestTemplates.append(t)
            last = v
            HIT = j
            Ms = MMs = Us = W1s = 0
        else:
            # first hit (savekmers.c:2656-2689)
            cnt = int(values[v])
            for t in values[v + 1: v + 1 + cnt].tolist():
                Score[t] = k * M
                include[t] = 1
                bestTemplates.append(t)
            last = v
            HIT = j

    # final flush (savekmers.c:2707-2753)
    score = Ms * M + MMs * MM + Us * U + W1s * W1
    cnt = int(values[last])
    for t in values[last + 1: last + 1 + cnt].tolist():
        Score[t] += score
        extendScore[t] = HIT
    for t in bestTemplates:
        extendScore[t] = 0
        include[t] = 0
        if Score[t] < 0:
            Score[t] = 0

    return get_match(bestTemplates, Score, proxi)


class Proxi:
    """-proxi configuration for the scan-level match selectors.

    min_frac is the |value| handed to the scanners (kmers.c:133-142 negates
    a soft -proxi before initialising the get* selectors); soft is the
    softProxi accumulator array, allocated only for mem_mode with a
    negative -proxi, whose totals later REPLACE alignment_scores
    (runkma.c:1154-1156)."""

    __slots__ = ("min_frac", "soft")

    def __init__(self, min_frac: float, soft=None):
        self.min_frac = min_frac
        self.soft = soft


def get_match(cands: List[int], Score, proxi: Optional[Proxi] = None
              ) -> Tuple[int, List[int]]:
    """getBestMatch (savekmers.c:273-294) / getProxiMatch (:296-340)."""
    bestScore = 0
    best: List[int] = []
    if proxi is None:
        for t in cands:
            s = int(Score[t])
            if s > bestScore:
                bestScore = s
                best = [t]
            elif s == bestScore:
                best.append(t)
            Score[t] = 0
    else:
        for t in cands:
            if bestScore < Score[t]:
                bestScore = int(Score[t])
        proxi_score = int(proxi.min_frac * bestScore)  # int truncation
        for t in cands:
            s = int(Score[t])
            if proxi_score <= s:
                best.append(t)
                if proxi.soft is not None:
                    proxi.soft[t] += s
            Score[t] = 0
    return bestScore, best


def ms_score(m_extra: int, mms: int, us: int, w1s: int,
             M: int, MM: int, U: int, W1: int) -> int:
    return m_extra * M + mms * MM + us * U + w1s * W1


class SaveKmersScanner:
    """Stateful per-read -1t1 scanner with reusable DB_size score arrays."""

    def __init__(self, idx: KmaIndex, rewards: Penalties,
                 exhaustive: bool = False, proxi: Optional[Proxi] = None):
        self.idx = idx
        self.rewards = rewards
        self.exhaustive = exhaustive
        self.proxi = proxi
        # +1: a deCon DB's values contain the contamination id == DB_size
        # (decon.c:113; the reference relies on calloc slop there)
        n = idx.db_size + 1
        self.Score = np.zeros(n, dtype=np.int64)
        self.Score_r = np.zeros(n, dtype=np.int64)
        self.extendScore = np.zeros(n, dtype=np.int64)
        self.include = np.zeros(n, dtype=np.uint8)

    def scan(self, codes: np.ndarray, n_positions: np.ndarray,
             header: bytes) -> Optional[AnkerHit]:
        """Scan one read; returns the anker record or None if unmapped
        (save_kmers, savekmers.c:2442-3065)."""
        idx = self.idx
        k = idx.kmersize
        if len(codes) < k:
            return None
        codes_r = rc_codes(codes)
        from .native_chain import engine_for
        eng = engine_for(idx, self.rewards)
        if eng is not None:
            (bestScore, best), (bestScore_r, best_r) = eng.save_kmers(
                codes, self.exhaustive, self.Score, self.Score_r,
                self.extendScore, self.include, self.proxi)
        else:
            bestScore, best = _scan_strand(idx, codes, self.rewards,
                                           self.exhaustive, False,
                                           self.Score, self.extendScore,
                                           self.include, self.proxi)
            bestScore_r, best_r = _scan_strand(idx, codes_r, self.rewards,
                                               self.exhaustive, True,
                                               self.Score_r,
                                               self.extendScore,
                                               self.include, self.proxi)
        if bestScore <= 0 and bestScore_r <= 0:
            return None
        if k > bestScore and k > bestScore_r:
            return None
        q_len = len(codes)
        if bestScore > bestScore_r:
            return AnkerHit(codes=codes, n_positions=n_positions,
                            rc_flag=bestScore,
                            templates=np.asarray(best, dtype=np.int32),
                            header=header, flag=0)
        if bestScore < bestScore_r:
            n_r = (q_len - 1) - n_positions[::-1] if len(n_positions) else n_positions
            return AnkerHit(codes=codes_r, n_positions=n_r.astype(np.int32),
                            rc_flag=bestScore_r,
                            templates=np.asarray(best_r, dtype=np.int32),
                            header=header, flag=16)
        merged = np.asarray(best + [-t for t in best_r], dtype=np.int32)
        return AnkerHit(codes=codes, n_positions=n_positions,
                        rc_flag=-bestScore, templates=merged,
                        header=header, flag=0)


def _count_strand(idx: KmaIndex, codes: np.ndarray, seg_ends, seqend: int,
                  exhaustive: bool, Score, proxi=None,
                  voffs=None) -> Tuple[int, list]:
    """One strand of save_kmers_count (savekmers.c:3096-3214): runs of
    identical value lists accumulate their repetition count; misses do
    not break a run.  ``voffs`` (device pre-lookups, -1 = miss) replace
    the per-window hash probes; valid only for N-free reads, where the
    window set is identical."""
    k = idx.kmersize
    seqlen = len(codes)
    # quick stride-k probe per segment
    hit = bool(exhaustive)
    j = 0
    for ni in seg_ends + [seqlen]:
        if hit:
            break
        end = ni - k + 1
        while j < end:
            if (voffs[j] >= 0 if voffs is not None
                    else idx.lookup(int(_kmer_at(codes, j, k)))
                    is not None):
                hit = True
                break
            j += k
        j = ni + 1
    if not hit:
        return 0, []

    hit_counter = 0
    bests: list = []
    Score_local = Score
    last = None
    last_list = None
    reps = 0
    j = 0
    kmers = (scan_keys(idx, codes)
             if voffs is None and seqlen >= k else None)
    values = idx.values
    for i, ni in enumerate(seg_ends + [seqlen]):
        if j >= seqend:
            break
        end = ni
        s = j
        for j2 in range(s, end - k + 1):
            if voffs is not None:
                vo = int(voffs[j2])
                if vo >= 0:
                    if vo == last:
                        reps += 1
                    else:
                        if last is not None:
                            for t in last_list:
                                Score_local[t] += reps
                                if Score_local[t] == reps:
                                    bests.append(int(t))
                            hit_counter += reps
                        reps = 1
                        last = vo
                        last_list = np.asarray(
                            values[vo + 1: vo + 1 + int(values[vo])],
                            np.int64)
                continue
            v = idx.lookup(int(kmers[j2]))
            if v is not None:
                key = v.__array_interface__["data"][0]
                if key == last:
                    reps += 1
                else:
                    if last is not None:
                        for t in last_list:
                            Score_local[t] += reps
                            if Score_local[t] == reps:
                                bests.append(int(t))
                        hit_counter += reps
                    reps = 1
                    last = key
                    last_list = np.asarray(v[1:], np.int64)
        j = end + 1
    if last is not None:
        for t in last_list:
            Score_local[t] += reps
            if Score_local[t] == reps:
                bests.append(int(t))
        hit_counter += reps

    if hit_counter:
        # getMatch (savekmers.c:3189): counts are the scores
        return get_match(bests, Score_local, proxi)
    for t in bests:
        Score_local[t] = 0
    return 0, []


def _kmer_at(codes: np.ndarray, pos: int, k: int) -> int:
    v = 0
    for c in codes[pos: pos + k].tolist():
        v = (v << 2) | (c & 3)
    return v


def save_kmers_count(idx: KmaIndex, pen: Penalties, codes: np.ndarray,
                     n_positions: np.ndarray, header: bytes,
                     exhaustive: bool, Score, Score_r,
                     proxi: Optional[Proxi] = None,
                     lookups=None) -> Optional[AnkerHit]:
    """-ck scanner (save_kmers_count, savekmers.c:3067-3365): pure k-mer
    counting over both strands; the winning strand (or a merged record on
    a tie) is emitted.  QUIRK kept: the rc pass segments the read with
    the FORWARD strand's N positions (savekmers.c:3250)."""
    k = idx.kmersize
    seqlen = len(codes)
    if seqlen < k:
        return None
    seqend = seqlen - k + 1
    segs_f = [int(x) for x in n_positions]
    codes_r = rc_codes(codes)

    from .native_chain import engine_for
    eng = engine_for(idx, pen)
    if lookups is not None and len(n_positions) == 0 \
            and len(lookups[0]) >= seqend:
        # device pre-lookups (devserve chain op): valid for N-free
        # reads only -- the rc quirk (fw segment boundaries on the rc
        # strand, savekmers.c:3250) never bites without Ns, so the
        # window sets match the host scan exactly
        vf, vr = lookups
        bestScore, bests = _count_strand(idx, codes, list(segs_f),
                                         seqend, exhaustive, Score,
                                         proxi, voffs=vf)
        bestScore_r, bests_r = _count_strand(idx, codes_r, list(segs_f),
                                             seqend, exhaustive, Score_r,
                                             proxi, voffs=vr)
    elif eng is not None:
        (bestScore, bests), (bestScore_r, bests_r) = eng.save_kmers_count(
            codes, n_positions, exhaustive, Score, Score_r, proxi)
    else:
        bestScore, bests = _count_strand(idx, codes, list(segs_f), seqend,
                                         exhaustive, Score, proxi)
        # rc strand reuses the fw segment boundaries (reference bug kept)
        bestScore_r, bests_r = _count_strand(idx, codes_r, list(segs_f),
                                             seqend, exhaustive, Score_r,
                                             proxi)

    if bestScore > 0 or bestScore_r > 0:
        if k <= bestScore or k <= bestScore_r:
            if bestScore > bestScore_r:
                return AnkerHit(codes, n_positions, bestScore,
                                np.asarray(bests, np.int32), header, 0)
            if bestScore < bestScore_r:
                npr = np.sort((seqlen - 1)
                              - np.asarray(n_positions)[::-1]) \
                    if len(n_positions) else n_positions
                return AnkerHit(codes_r, npr.astype(np.int32), bestScore_r,
                                np.asarray(bests_r, np.int32), header, 16)
            merged = bests + [-t for t in bests_r]
            return AnkerHit(codes, n_positions, -bestScore,
                            np.asarray(merged, np.int32), header, 0)
    return None

"""End-to-end mapping pipeline: the runKMA flow (reference runkma.c:130-908).

Stages (in-process instead of the reference's pipe-chained processes):
  1. read input + trimming          (io.pipeline.iter_reads)
  2. k-mer scan -> anker records     (mapping.scan.SaveKmersScanner)
  3. per-candidate alignment scoring (alnFragsSE, alnfrags.c:1052-1218)
  4. ConClave-1 assignment           (assign.conclave)
  5. per-template assembly/consensus (assemble.pileup)
  6. output files                    (out.writers)
"""

from __future__ import annotations

import math
import bisect
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from .align.cci import TemplateIndex
from .align.kma_aln import (Penalty, Points, anker_rc_comp, kma_align,
                            set_preseed_exhaustive)
from .assemble.pileup import (Assem, AssemblyMatrix, call_consensus,
                              get_extended_features, trim_dual_gaps)
from .assign.conclave import Frag, FragRecord, run_conclave1
from .config import MapConfig
from .index.format import KmaIndex, load_index, seq_offsets
from .io.pipeline import Read, iter_reads
from .io.seq import rc_codes, unpack_2bit
from .mapping.scan import SaveKmersScanner
from .out import writers
from .out.writers import tsv_headerline, tsv_row
from .utils.stats import CMP, p_chisqr

CMP_CODE = {"or": 0, "and": 1, "true": 2}


def mrcheck(mrc: float, st, q_len: int, t_len: int) -> bool:
    """alnfrags.c:38."""
    return (mrc * q_len <= st.len - st.qGaps
            or mrc * t_len <= st.len - st.tGaps)


class TemplateStore:
    """Lazy per-template CCI indexes over .seq.b (templates_index[],
    runkma.c:203, alignLoad_fly)."""

    def __init__(self, seq_path: str, template_lengths: np.ndarray,
                 kmersize: int):
        self.seq_path = seq_path
        self.lengths = template_lengths
        self.offsets = seq_offsets(template_lengths)
        self.kmersize = kmersize
        self.cache: Dict[int, TemplateIndex] = {}
        self._mm = None

    def _words(self, template: int, nwords: int) -> np.ndarray:
        if self._mm is None:
            self._mm = np.memmap(self.seq_path, dtype="<u8", mode="r")
        w0 = int(self.offsets[template]) >> 3
        return np.asarray(self._mm[w0:w0 + nwords])

    def get(self, template: int) -> TemplateIndex:
        ti = self.cache.get(template)
        if ti is None:
            t_len = int(self.lengths[template])
            words = self._words(template, (t_len >> 5) + 1)
            ti = TemplateIndex(unpack_2bit(words, t_len), self.kmersize)
            self.cache[template] = ti
        return ti


def _stage(msg: str) -> None:
    """Reference stderr stage lines (runkma.c:290,556-560; kmers.c:182)."""
    print(msg, file=sys.stderr)
    sys.stderr.flush()


def _shard_of(biases: List[int], template: int) -> int:
    """Shard owning a global template id; biases[n] <= id < biases[n+1]."""
    n = bisect.bisect_right(biases, template) - 1
    return min(n, len(biases) - 2)


class MultiTemplateStore:
    """Global-template lookup over per-shard .seq.b files (the reducer
    swaps seq/name streams at each dbBias boundary, spltdb.c:1074-1129)."""

    def __init__(self, db_prefixes: List[str],
                 lengths_parts: List[np.ndarray], biases: List[int],
                 kmersize: int):
        self.stores = [TemplateStore(p + ".seq.b", lp, kmersize)
                       for p, lp in zip(db_prefixes, lengths_parts)]
        self.biases = biases

    def get(self, template: int) -> TemplateIndex:
        n = _shard_of(self.biases, template)
        return self.stores[n].get(template - self.biases[n])


def aln_frags_se(store: TemplateStore, matched_templates: np.ndarray,
                 rc_flag: int, codes: np.ndarray, codes_r: np.ndarray,
                 n_pos: np.ndarray, n_pos_r: np.ndarray, header: bytes,
                 flag: int, kmersize: int, minlen: int, mq: int,
                 scoreT: float, mrc: float, rew: Penalty,
                 points: Points, min_frac: float = 1.0
                 ) -> Optional[FragRecord]:
    """alnFragsSE (alnfrags.c:1052-1218): score the read against every
    candidate template, keep best hits, emit the spool record."""
    q_len = len(codes)
    arc = rc_flag < 0
    Wl = -rew.Wl

    best_templates: List[int] = []
    best_start: List[int] = []
    best_end: List[int] = []
    scores: List[int] = []
    lengths: List[int] = []
    bestScore = 0.0
    best_read_score = 0

    for tt in matched_templates.tolist():
        template = tt
        tindex = store.get(abs(template))
        t_len = tindex.len
        # q-bound (alnfrags.c:1091-1099): chain/HMM records carry bounds
        q_start, q_end = 0, q_len
        if len(header) > 2 * 4 + 1 and header[len(header) - 2 * 4 - 1] == 0:
            import struct
            q_start, q_end = struct.unpack_from("<ii", header,
                                                len(header) - 8)

        points.len = 0
        if arc:
            rc = anker_rc_comp(tindex, codes, codes_r, n_pos, n_pos_r, q_len,
                               q_start, q_end, points, 1)
            if rc < 0:
                if 0 < template:
                    template = -template
                st, _, _ = kma_align(tindex, codes_r, q_len,
                                     q_len - q_end, q_len - q_start, 0, 0,
                                     mq, rew, points, kmersize,
                                     traceback=False, n_positions=n_pos_r)
            elif rc:
                if template < 0:
                    template = -template
                st, _, _ = kma_align(tindex, codes, q_len, q_start, q_end,
                                     0, 0, mq, rew, points, kmersize,
                                     traceback=False, n_positions=n_pos)
            else:
                from .align.nw import AlnScore
                st = AlnScore()
                points.len = 0
        else:
            if template < 0:
                st, _, _ = kma_align(tindex, codes_r, q_len, q_len - q_end,
                                     q_len - q_start, 0, 0, mq, rew, points,
                                     kmersize, traceback=False,
                                     n_positions=n_pos_r)
            else:
                st, _, _ = kma_align(tindex, codes, q_len, q_start, q_end,
                                     0, 0, mq, rew, points, kmersize,
                                     traceback=False, n_positions=n_pos)

        aln_len = st.len
        start = st.pos
        end = start + aln_len - st.tGaps
        if t_len < end:
            end -= t_len
        # normed score denominator (alnfrags.c:1140-1154)
        if q_len <= aln_len or t_len <= aln_len:
            denom = float(aln_len)
        else:
            denom = float(q_len if q_len < t_len else t_len)
        read_score = st.score
        if minlen <= aln_len and mrcheck(mrc, st, q_len, t_len):
            score = read_score / denom
        else:
            read_score = 0
            score = 0.0

        if kmersize < read_score and scoreT <= score:
            best_templates.append(template)
            best_start.append(start)
            best_end.append(end)
            scores.append(read_score)
            lengths.append(aln_len)
            if bestScore < score:
                bestScore = score
            if best_read_score < read_score:
                best_read_score = read_score

    if best_read_score > kmersize:
        return update_scores(codes, q_len, min_frac, len(best_templates),
                             best_read_score, bestScore, best_start,
                             best_end, best_templates, scores, lengths,
                             header, flag)
    return None


def update_scores(codes: np.ndarray, q_len: int, min_frac: float,
                  counter: int, best_read_score: int, best_score: float,
                  starts: List[int], ends: List[int], templates: List[int],
                  scores: List[int], lengths: List[int], header: bytes,
                  flag: int) -> FragRecord:
    """update_Scores (updatescores.c:203-298).

    NOTE (minFrac==1.0): `minScore = score / Lengths[i]` is C INTEGER
    division assigned to a double (updatescores.c:220) while best_score is
    a float ratio; the filter is effectively `score == bestReadScore` plus
    exact int/float coincidences — reproduced verbatim.  The -proxi
    branches (:235-272) keep scores within minFrac of the best per-length
    or absolute score; soft (-minFrac) accumulates the aln score itself,
    hard accumulates bestReadScore.
    """
    sel_t: List[int] = []
    sel_s: List[int] = []
    sel_e: List[int] = []
    sel_score: List[int] = []
    if min_frac == 1.0:
        for i in range(counter):
            score = scores[i]
            ln = lengths[i]
            min_score = float(score // ln if (score >= 0) == (ln > 0)
                              else -((-score) // ln)) if ln else 0.0
            if min_score == best_score or score == best_read_score:
                sel_t.append(templates[i])
                sel_s.append(starts[i])
                sel_e.append(ends[i])
                sel_score.append(score)
    else:
        mf = abs(min_frac)
        min_score = mf * best_score
        min_read = mf * best_read_score
        acc_is_score = min_frac < 0
        for i in range(counter):
            score = scores[i]
            if lengths[i] * min_score <= score or min_read <= score:
                sel_t.append(templates[i])
                sel_s.append(starts[i])
                sel_e.append(ends[i])
                sel_score.append(score if acc_is_score
                                 else best_read_score)
    return FragRecord(q_len=q_len, best_hits=len(sel_t),
                      score=best_read_score, header=header, flag=flag,
                      codes=codes, starts=sel_s, ends=sel_e,
                      templates=sel_t, ), sel_score


def update_scores_se(codes, q_len, min_frac, ids, scores, starts, ends,
                     best_score, header, flag, alignment_scores,
                     uniq_alignment_scores):
    """update_Scores_se (updatescores.c:300-388)."""
    sel_t, sel_s, sel_e = [], [], []
    if min_frac == 1.0:
        for i in range(len(ids)):
            if scores[i] == best_score:
                sel_t.append(ids[i])
                sel_s.append(starts[i])
                sel_e.append(ends[i])
                alignment_scores[abs(ids[i])] += best_score
    else:
        mf = abs(min_frac) * best_score
        for i in range(len(ids)):
            if mf <= scores[i]:
                sel_t.append(ids[i])
                sel_s.append(starts[i])
                sel_e.append(ends[i])
                alignment_scores[abs(ids[i])] += \
                    scores[i] if min_frac < 0 else best_score
    if len(sel_t) == 1:
        uniq_alignment_scores[abs(sel_t[0])] += best_score
    return FragRecord(q_len=q_len, best_hits=len(sel_t), score=best_score,
                      header=header, flag=flag, codes=codes, starts=sel_s,
                      ends=sel_e, templates=sel_t)


def update_scores_pe(codes, q_len, mate_codes, mate_len, min_frac, ids,
                     scores, starts, ends, best_score, header, mate_header,
                     flag, mate_flag, alignment_scores,
                     uniq_alignment_scores):
    """update_Scores_pe (updatescores.c:390-488)."""
    sel_t, sel_s, sel_e = [], [], []
    if min_frac == 1.0:
        for i in range(len(ids)):
            if scores[i] == best_score:
                sel_t.append(ids[i])
                sel_s.append(starts[i])
                sel_e.append(ends[i])
                alignment_scores[abs(ids[i])] += scores[i]
    else:
        mf = abs(min_frac) * best_score
        for i in range(len(ids)):
            if mf <= scores[i]:
                sel_t.append(ids[i])
                sel_s.append(starts[i])
                sel_e.append(ends[i])
                alignment_scores[abs(ids[i])] += \
                    scores[i] if min_frac < 0 else best_score
    if len(sel_t) == 1:
        uniq_alignment_scores[abs(sel_t[0])] += best_score
    return FragRecord(q_len=q_len, best_hits=len(sel_t), score=-best_score,
                      header=header, flag=flag, codes=codes, starts=sel_s,
                      ends=sel_e, templates=sel_t, mate_codes=mate_codes,
                      mate_header=mate_header, mate_flag=mate_flag)



def _pe_gate(read_score, aln, pos, tg, qg, q_len, t_len, minlen, mrc, Wl):
    """Per-mate PE gate + full-gene Wl bonus (alnfrags.c:1320-1344):
    returns (read_score-or-0, score, start, end)."""
    score = 0.0
    start = end = 0
    if (minlen <= aln and 0 < read_score
            and (mrc * q_len <= aln - qg or mrc * t_len <= aln - tg)):
        start = pos
        end = pos + aln - tg
        if start == 0:
            read_score += Wl
        if end == t_len:
            read_score += Wl
        score = 1.0 * read_score / aln
    else:
        read_score = 0
    return read_score, score, start, end


def _pe_native_stats(store, tids, codes_a, codes_b, arc, mq, rew,
                     minlen=16, mrc=0.0):
    """Raw per-(pair, template) mate AlnStats via the native batch scorer
    (kaln_pe_score_batch); mutates tids for arc picks.  None = take the
    Python scoring loop."""
    from .align import native_aln as _nat
    if _nat.get_lib() is None or os.environ.get("KMA_TPU_NO_NATIVE"):
        return None
    n = len(tids)
    handles = np.empty(n, np.uint64)
    for i, t in enumerate(tids):
        handles[i] = _nat.native_handle(store.get(abs(int(t))))
    tpl = np.asarray(tids, np.int32)
    off = np.array([0, n], np.int64)
    a = np.ascontiguousarray(codes_a, np.uint8)
    b = np.ascontiguousarray(codes_b, np.uint8)
    a_off = np.array([0, len(a)], np.int64)
    b_off = np.array([0, len(b)], np.int64)
    arcs = np.array([1 if arc else 0], np.uint8)
    out = _nat.pe_score_batch(handles, tpl, off, a, a_off, b, b_off,
                              arcs, rew, mq, 1, minlen=minlen, mrc=mrc)
    tids[:] = tpl.tolist()
    return out


def aln_frags_union_pe(store: TemplateStore, matched: np.ndarray,
                       codes_a: np.ndarray, codes_b: np.ndarray,
                       header_a: bytes, header_b: bytes, flag_a: int,
                       flag_b: int, kmersize: int, minlen: int, mq: int,
                       scoreT: float, mrc: float, min_frac: float,
                       rew: Penalty, points: Points, alignment_scores,
                       uniq_alignment_scores,
                       arc: bool = False, sam_cb=None,
                       nat=None) -> List[FragRecord]:
    """alnFragsUnionPE (alnfrags.c:1220-1594).

    arc (points->len, set when the pair record's rc_flag is negative --
    always for sparse-DB records) switches to per-template orientation
    via anker_rc_comp; a forward pick NEGATES the matched id
    (alnfrags.c:1286)."""
    Wl = -rew.Wl
    n = len(matched)
    rc_a = rc_codes(codes_a)
    rc_b = rc_codes(codes_b)
    np_a = np.flatnonzero(codes_a == 4).astype(np.int64)
    np_ar = np.flatnonzero(rc_a == 4).astype(np.int64)
    np_b = np.flatnonzero(codes_b == 4).astype(np.int64)
    np_br = np.flatnonzero(rc_b == 4).astype(np.int64)

    scores1 = [0] * n
    scores2 = [0] * n
    starts = [0] * n
    ends = [0] * n
    best1 = best2 = 0
    flipped = False
    tids = matched.tolist()

    if nat is None:
        nat = _pe_native_stats(store, tids, codes_a, codes_b, arc, mq,
                               rew)
    if nat is not None:
        sc1, po1, ln1, tg1, qg1, sc2, po2, ln2, tg2, qg2, flp = nat
        flipped = bool(flp[0])
        for t_i in range(n):
            t_len = store.get(abs(tids[t_i])).len
            rs, score, start, end = _pe_gate(
                int(sc1[t_i]), int(ln1[t_i]), int(po1[t_i]),
                int(tg1[t_i]), int(qg1[t_i]), len(codes_a), t_len,
                minlen, mrc, Wl)
            if rs > kmersize and score >= scoreT:
                scores1[t_i] = rs
                starts[t_i] = start
                ends[t_i] = end
                if best1 < rs:
                    best1 = rs
            else:
                scores1[t_i] = 0
                starts[t_i] = -1
                ends[t_i] = -1
            rs, score, start, end = _pe_gate(
                int(sc2[t_i]), int(ln2[t_i]), int(po2[t_i]),
                int(tg2[t_i]), int(qg2[t_i]), len(codes_b), t_len,
                minlen, mrc, Wl)
            if rs > kmersize and score >= scoreT:
                scores2[t_i] = rs
                if scores1[t_i]:
                    if start < starts[t_i]:
                        starts[t_i] = start
                    else:
                        ends[t_i] = end
                else:
                    starts[t_i] = start
                    ends[t_i] = end
                if best2 < rs:
                    best2 = rs
            else:
                scores2[t_i] = 0

    for t_i in (range(n) if nat is None else ()):
        template = tids[t_i]
        if template < 0 and not flipped and not arc:
            flipped = True
        t = abs(template)
        tindex = store.get(t)
        t_len = tindex.len
        if arc:
            # per-template orientation pick on mate1 (alnfrags.c:1280)
            points.len = 0
            rcres = anker_rc_comp(tindex, codes_a, rc_a, np_a, np_ar,
                                  len(codes_a), 0, len(codes_a), points, 1)
            if rcres < 0:
                cur_a, na = rc_a, np_ar
            elif rcres:
                tids[t_i] = -tids[t_i]
                cur_a, na = codes_a, np_a
            else:
                cur_a = na = None
        else:
            cur_a = rc_a if flipped else codes_a
            na = np_ar if flipped else np_a
            points.len = 0
        if cur_a is not None:
            st, _, _ = kma_align(tindex, cur_a, len(cur_a), 0, len(cur_a),
                                 0, 0, mq, rew, points, kmersize,
                                 traceback=False, n_positions=na)
        else:
            from .align.nw import AlnScore
            st = AlnScore()
            points.len = 0
        read_score = st.score
        score = 0.0
        start = end = 0
        if (minlen <= st.len and 0 < read_score
                and mrcheck(mrc, st, len(codes_a), t_len)):
            start = st.pos
            end = st.pos + st.len - st.tGaps
            if start == 0:
                read_score += Wl
            if end == t_len:
                read_score += Wl
            score = 1.0 * read_score / st.len
        else:
            read_score = 0
        if read_score > kmersize and score >= scoreT:
            scores1[t_i] = read_score
            starts[t_i] = start
            ends[t_i] = end
            if best1 < read_score:
                best1 = read_score
        else:
            scores1[t_i] = 0
            starts[t_i] = -1
            ends[t_i] = -1

        if arc:
            if cur_a is rc_a:
                cur_b, nb = rc_b, np_br
            elif cur_a is codes_a:
                cur_b, nb = codes_b, np_b
            else:
                cur_b = nb = None
        else:
            cur_b = rc_b if flipped else codes_b
            nb = np_br if flipped else np_b
        points.len = 0
        if cur_b is not None:
            st, _, _ = kma_align(tindex, cur_b, len(cur_b), 0, len(cur_b),
                                 0, 0, mq, rew, points, kmersize,
                                 traceback=False, n_positions=nb)
        else:
            from .align.nw import AlnScore
            st = AlnScore()
        read_score = st.score
        score = 0.0
        if (minlen <= st.len and 0 < read_score
                and mrcheck(mrc, st, len(codes_b), t_len)):
            start = st.pos
            end = st.pos + st.len - st.tGaps
            if start == 0:
                read_score += Wl
            if end == t_len:
                read_score += Wl
            score = 1.0 * read_score / st.len
        else:
            read_score = 0
        if read_score > kmersize and score >= scoreT:
            scores2[t_i] = read_score
            if scores1[t_i]:
                # negative insert sizes (alnfrags.c:1376-1386)
                if start < starts[t_i]:
                    starts[t_i] = start
                else:
                    ends[t_i] = end
            else:
                starts[t_i] = start
                ends[t_i] = end
            if best2 < read_score:
                best2 = read_score
        else:
            scores2[t_i] = 0

    # qseq bytes at emission time, and after an emission-time strrc
    cur_a = (rc_a if flipped else codes_a) if not arc else codes_a
    cur_b = (rc_b if flipped else codes_b) if not arc else codes_b
    if not best1 and not best2:
        # both mates fail: the worker reports both unmapped with the
        # UNmutated anker flags (alnfrags.c:1593 return 3 + :2261-2273)
        if sam_cb is not None:
            sam_cb(cur_a, header_a, flag_a)
            sam_cb(cur_b, header_b, flag_b)
        return []
    # rc marker (alnfrags.c:1402-1407): arc scans the (mutated) tid signs;
    # non-arc rc==0 iff the reads were scan-flipped in place
    if arc:
        rc_state = any(t < 0 for t in tids)
    else:
        rc_state = not flipped
    res_a = codes_a if not arc else rc_a
    res_b = codes_b if not arc else rc_b
    recs: List[FragRecord] = []
    mf = abs(min_frac)
    if best1 and best2:
        # check union (alnfrags.c:1411-1424)
        thr1 = best1 * mf
        thr2 = best2 * mf
        u_ids, u_scores, u_starts, u_ends = [], [], [], []
        for t_i in range(n):
            if thr1 <= scores1[t_i] and thr2 <= scores2[t_i]:
                u_ids.append(tids[t_i])
                u_scores.append(scores1[t_i] + scores2[t_i])
                u_starts.append(starts[t_i])
                u_ends.append(ends[t_i])
        if u_ids:
            # proper pair (alnfrags.c:1426-1446)
            fa, fb = flag_a, flag_b
            if u_ids[0] < 0:
                u_ids = [-x for x in u_ids]
                recs.append(update_scores_pe(
                    cur_b, len(cur_b), cur_a, len(cur_a), min_frac, u_ids,
                    u_scores, u_starts, u_ends, best1 + best2, header_b,
                    header_a, fb, fa, alignment_scores,
                    uniq_alignment_scores))
            else:
                seq_a, seq_b = cur_a, cur_b
                if not rc_state:
                    seq_a, seq_b = res_a, res_b
                    fa ^= 48
                    fb ^= 48
                recs.append(update_scores_pe(
                    seq_a, len(seq_a), seq_b, len(seq_b), min_frac,
                    u_ids, u_scores, u_starts, u_ends, best1 + best2,
                    header_a, header_b, fa, fb, alignment_scores,
                    uniq_alignment_scores))
            return recs
        # unmaided pair (alnfrags.c:1447-1516): separate SE spools
        f_ids, f_sc, f_st, f_en = [], [], [], []
        r_ids, r_sc, r_st, r_en = [], [], [], []
        for t_i in range(n):
            if thr1 <= scores1[t_i]:
                f_ids.append(tids[t_i])
                f_sc.append(scores1[t_i])
                f_st.append(starts[t_i])
                f_en.append(ends[t_i])
            elif thr2 <= scores2[t_i]:
                r_ids.append(tids[t_i])
                r_sc.append(scores2[t_i])
                r_st.append(starts[t_i])
                r_en.append(ends[t_i])
        fa, fb = flag_a, flag_b
        seq_a = cur_a
        if f_ids and f_ids[0] < 0:
            f_ids = [-x for x in f_ids]
        elif not rc_state:
            seq_a = res_a
            fa ^= 16
            fb ^= 32
        seq_b = cur_b
        if r_ids and r_ids[0] < 0:
            r_ids = [-x for x in r_ids]
        elif not rc_state:
            seq_b = res_b
            fa ^= 32
            fb ^= 16
        if fa & 2:
            fa ^= 2
            fb ^= 2
        if f_ids:
            recs.append(update_scores_se(seq_a, len(seq_a), min_frac, f_ids,
                                         f_sc, f_st, f_en, best1, header_a,
                                         fa, alignment_scores,
                                         uniq_alignment_scores))
        if r_ids:
            recs.append(update_scores_se(seq_b, len(seq_b), min_frac, r_ids,
                                         r_sc, r_st, r_en, best2, header_b,
                                         fb, alignment_scores,
                                         uniq_alignment_scores))
        return recs
    if best1:
        # forward only (alnfrags.c:1518-1552)
        ids, sc, stl, enl = [], [], [], []
        for t_i in range(n):
            if scores1[t_i]:
                ids.append(tids[t_i])
                sc.append(scores1[t_i])
                stl.append(starts[t_i])
                enl.append(ends[t_i])
        fa, fb = flag_a, flag_b
        seq_a = cur_a
        if ids and ids[0] < 0:
            ids = [-x for x in ids]
        elif not rc_state:
            seq_a = res_a
            fa ^= 16
            fb ^= 32
        fa |= 8
        fb ^= 4
        if fa & 2:
            fa ^= 2
            fb ^= 2
        recs.append(update_scores_se(seq_a, len(seq_a), min_frac, ids, sc,
                                     stl, enl, best1, header_a, fa,
                                     alignment_scores,
                                     uniq_alignment_scores))
        if sam_cb is not None:  # mate b unmapped (return 2)
            sam_cb(cur_b, header_b, fb)
        return recs
    # reverse only (alnfrags.c:1553-1590)
    ids, sc, stl, enl = [], [], [], []
    for t_i in range(n):
        if scores2[t_i]:
            ids.append(tids[t_i])
            sc.append(scores2[t_i])
            stl.append(starts[t_i])
            enl.append(ends[t_i])
    fa, fb = flag_a, flag_b
    seq_b = cur_b
    if ids and ids[0] < 0:
        ids = [-x for x in ids]
    elif not rc_state:
        seq_b = res_b
        fa ^= 32
        fb ^= 16
    fb |= 8
    fa ^= 4
    if fb & 2:
        fa ^= 2
        fb ^= 2
    recs.append(update_scores_se(seq_b, len(seq_b), min_frac, ids, sc, stl,
                                 enl, best2, header_b, fb, alignment_scores,
                                 uniq_alignment_scores))
    if sam_cb is not None:  # mate a unmapped (return 1)
        sam_cb(cur_a, header_a, fa)
    return recs


def aln_frags_penalty_pe(store: TemplateStore, matched: np.ndarray,
                         codes_a: np.ndarray, codes_b: np.ndarray,
                         header_a: bytes, header_b: bytes, flag_a: int,
                         flag_b: int, arc: bool, kmersize: int, minlen: int,
                         mq: int, scoreT: float, mrc: float,
                         min_frac: float, rew: Penalty, points: Points,
                         alignment_scores, uniq_alignment_scores,
                         sam_cb=None, nat=None) -> List[FragRecord]:
    """alnFragsPenaltyPE (alnfrags.c:1596-1972): both mates scored per
    candidate; a pair is accepted when the best combined score + PE beats
    minFrac * (best1 + best2)."""
    Wl = -rew.Wl
    PE = rew.PE
    n = len(matched)
    rc_a = rc_codes(codes_a)
    rc_b = rc_codes(codes_b)
    np_a = np.flatnonzero(codes_a == 4).astype(np.int64)
    np_ar = np.flatnonzero(rc_a == 4).astype(np.int64)
    np_b = np.flatnonzero(codes_b == 4).astype(np.int64)
    np_br = np.flatnonzero(rc_b == 4).astype(np.int64)

    scores1 = [0] * n
    scores2 = [0] * n
    starts = [0] * n
    ends = [0] * n
    best1 = best2 = 0
    compScore = 0
    flipped = False
    tids = matched.tolist()

    def _score_mate(tindex, cur, npos_cur, pre_points):
        st, _, _ = kma_align(tindex, cur, len(cur), 0, len(cur), 0, 0, mq,
                             rew, points, kmersize, traceback=False,
                             n_positions=npos_cur)
        return st

    if nat is None:
        nat = _pe_native_stats(store, tids, codes_a, codes_b, arc, mq,
                               rew)
    if nat is not None:
        sc1, po1, ln1, tg1, qg1, sc2, po2, ln2, tg2, qg2, flp = nat
        flipped = bool(flp[0])
        for t_i in range(n):
            t_len = store.get(abs(tids[t_i])).len
            rs, score, start, end = _pe_gate(
                int(sc1[t_i]), int(ln1[t_i]), int(po1[t_i]),
                int(tg1[t_i]), int(qg1[t_i]), len(codes_a), t_len,
                minlen, mrc, Wl)
            if rs > kmersize and score >= scoreT:
                scores1[t_i] = rs
                starts[t_i] = start
                ends[t_i] = end
                if best1 < rs:
                    best1 = rs
            else:
                scores1[t_i] = 0
                starts[t_i] = -1
                ends[t_i] = -1
            rs, score, start, end = _pe_gate(
                int(sc2[t_i]), int(ln2[t_i]), int(po2[t_i]),
                int(tg2[t_i]), int(qg2[t_i]), len(codes_b), t_len,
                minlen, mrc, Wl)
            if rs > kmersize and score >= scoreT:
                scores2[t_i] = rs
                if scores1[t_i]:
                    if start < starts[t_i]:
                        starts[t_i] = start
                    else:
                        ends[t_i] = end
                else:
                    starts[t_i] = start
                    ends[t_i] = end
                if best2 < rs:
                    best2 = rs
            else:
                scores2[t_i] = 0
            # compScore uses the PRE-threshold mate2 score
            # (alnfrags.c:1784 keeps read_score across the gate)
            if compScore < rs + scores1[t_i]:
                compScore = rs + scores1[t_i]

    for t_i in (range(n) if nat is None else ()):
        template = tids[t_i]
        if template < 0 and not flipped and not arc:
            flipped = True
        t = abs(template)
        tindex = store.get(t)
        t_len = tindex.len
        if arc:
            # per-template orientation pick on mate1 (alnfrags.c:1657)
            points.len = 0
            rcres = anker_rc_comp(tindex, codes_a, rc_a, np_a, np_ar,
                                  len(codes_a), 0, len(codes_a), points, 1)
            if rcres < 0:
                cur_a, na = rc_a, np_ar
            elif rcres:
                tids[t_i] = -tids[t_i]
                cur_a, na = codes_a, np_a
            else:
                cur_a = None
        else:
            cur_a = rc_a if flipped else codes_a
            na = np_ar if flipped else np_a
            points.len = 0
        if cur_a is not None:
            st = _score_mate(tindex, cur_a, na, points)
        else:
            from .align.nw import AlnScore
            st = AlnScore()
        read_score = st.score
        score = 0.0
        start = end = 0
        if (minlen <= st.len and 0 < read_score
                and mrcheck(mrc, st, len(codes_a), t_len)):
            start = st.pos
            end = st.pos + st.len - st.tGaps
            if start == 0:
                read_score += Wl
            if end == t_len:
                read_score += Wl
            score = 1.0 * read_score / st.len
        else:
            read_score = 0
        if read_score > kmersize and score >= scoreT:
            scores1[t_i] = read_score
            starts[t_i] = start
            ends[t_i] = end
            if best1 < read_score:
                best1 = read_score
        else:
            scores1[t_i] = 0
            starts[t_i] = -1
            ends[t_i] = -1

        if arc:
            if cur_a is rc_a:
                cur_b, nb = rc_b, np_br
            elif cur_a is codes_a:
                cur_b, nb = codes_b, np_b
            else:
                cur_b = None
        else:
            cur_b = rc_b if flipped else codes_b
            nb = np_br if flipped else np_b
        points.len = 0
        if cur_b is not None:
            st = _score_mate(tindex, cur_b, nb, points)
        else:
            from .align.nw import AlnScore
            st = AlnScore()
        read_score = st.score
        score = 0.0
        if (minlen <= st.len and 0 < read_score
                and mrcheck(mrc, st, len(codes_b), t_len)):
            start = st.pos
            end = st.pos + st.len - st.tGaps
            if start == 0:
                read_score += Wl
            if end == t_len:
                read_score += Wl
            score = 1.0 * read_score / st.len
        else:
            read_score = 0
        if read_score > kmersize and score >= scoreT:
            scores2[t_i] = read_score
            if scores1[t_i]:
                if start < starts[t_i]:
                    starts[t_i] = start
                else:
                    ends[t_i] = end
            else:
                starts[t_i] = start
                ends[t_i] = end
            if best2 < read_score:
                best2 = read_score
        else:
            scores2[t_i] = 0
        if compScore < read_score + scores1[t_i]:
            compScore = read_score + scores1[t_i]

    if not best1 and not best2:
        if sam_cb is not None:  # both unmapped (return 3 + worker write)
            cu_a = (rc_a if flipped else codes_a) if not arc else codes_a
            cu_b = (rc_b if flipped else codes_b) if not arc else codes_b
            sam_cb(cu_a, header_a, flag_a)
            sam_cb(cu_b, header_b, flag_b)
        return []
    # rc orientation marker (alnfrags.c:1778-1783): non-arc rc==0 means
    # the reads were scan-flipped in place; arc rc from the tid signs
    if arc:
        rc_state = any(t < 0 for t in tids)
    else:
        rc_state = not flipped
    # "current" = the bytes the C qseq holds at emission time;
    # "restored" = after the emission-time strrc of the !rc branches
    cur_a = (rc_a if flipped else codes_a) if not arc else codes_a
    cur_b = (rc_b if flipped else codes_b) if not arc else codes_b
    res_a = codes_a if not arc else rc_a
    res_b = codes_b if not arc else rc_b
    recs: List[FragRecord] = []
    mf = abs(min_frac)
    pair_gate = mf * (best1 + best2)
    if compScore and pair_gate <= compScore + PE:
        # proper pair (alnfrags.c:1789-1824)
        p_ids, p_sc, p_st, p_en = [], [], [], []
        for t_i in range(n):
            if scores1[t_i] and scores2[t_i]:
                p_ids.append(tids[t_i])
                p_sc.append(scores1[t_i] + scores2[t_i] + PE)
                p_st.append(starts[t_i])
                p_en.append(ends[t_i])
        best = compScore + PE
        fa, fb = flag_a, flag_b
        if p_ids and p_ids[0] < 0:
            p_ids = [-x for x in p_ids]
            recs.append(update_scores_pe(
                cur_b, len(cur_b), cur_a, len(cur_a), min_frac, p_ids,
                p_sc, p_st, p_en, best, header_b, header_a, fb, fa,
                alignment_scores, uniq_alignment_scores))
        else:
            seq_a, seq_b = cur_a, cur_b
            if not rc_state:
                seq_a, seq_b = res_a, res_b
                fa ^= 48
                fb ^= 48
            recs.append(update_scores_pe(
                seq_a, len(seq_a), seq_b, len(seq_b), min_frac, p_ids,
                p_sc, p_st, p_en, best, header_a, header_b, fa, fb,
                alignment_scores, uniq_alignment_scores))
        return recs
    if best1 and best2:
        # unmaided pair (alnfrags.c:1825-1895)
        thr1 = mf * best1
        thr2 = mf * best2
        f_ids, f_sc, f_st, f_en = [], [], [], []
        r_ids, r_sc, r_st, r_en = [], [], [], []
        for t_i in range(n):
            if thr1 <= scores1[t_i]:
                f_ids.append(tids[t_i])
                f_sc.append(scores1[t_i])
                f_st.append(starts[t_i])
                f_en.append(ends[t_i])
            elif thr2 <= scores2[t_i]:
                r_ids.append(tids[t_i])
                r_sc.append(scores2[t_i])
                r_st.append(starts[t_i])
                r_en.append(ends[t_i])
        fa, fb = flag_a, flag_b
        seq_a, seq_b = cur_a, cur_b
        if f_ids and f_ids[0] < 0:
            f_ids = [-x for x in f_ids]
        elif not rc_state:
            seq_a = res_a
            fa ^= 16
            fb ^= 32
        if r_ids and r_ids[0] < 0:
            r_ids = [-x for x in r_ids]
        elif not rc_state:
            seq_b = res_b
            fa ^= 32
            fb ^= 16
        if fa & 2:
            fa ^= 2
            fb ^= 2
        if f_ids:
            recs.append(update_scores_se(seq_a, len(seq_a), min_frac,
                                         f_ids, f_sc, f_st, f_en, best1,
                                         header_a, fa, alignment_scores,
                                         uniq_alignment_scores))
        if r_ids:
            recs.append(update_scores_se(seq_b, len(seq_b), min_frac,
                                         r_ids, r_sc, r_st, r_en, best2,
                                         header_b, fb, alignment_scores,
                                         uniq_alignment_scores))
        return recs
    if best1:
        ids, sc, stl, enl = [], [], [], []
        for t_i in range(n):
            if scores1[t_i]:
                ids.append(tids[t_i])
                sc.append(scores1[t_i])
                stl.append(starts[t_i])
                enl.append(ends[t_i])
        fa, fb = flag_a, flag_b
        seq_a = cur_a
        if ids and ids[0] < 0:
            ids = [-x for x in ids]
        elif not rc_state:
            seq_a = res_a
            fa ^= 16
            fb ^= 32
        fa |= 8
        fb ^= 4
        if fa & 2:
            fa ^= 2
            fb ^= 2
        recs.append(update_scores_se(seq_a, len(seq_a), min_frac, ids, sc,
                                     stl, enl, best1, header_a, fa,
                                     alignment_scores,
                                     uniq_alignment_scores))
        if sam_cb is not None:  # mate b unmapped (return 2)
            sam_cb(cur_b, header_b, fb)
        return recs
    ids, sc, stl, enl = [], [], [], []
    for t_i in range(n):
        if scores2[t_i]:
            ids.append(tids[t_i])
            sc.append(scores2[t_i])
            stl.append(starts[t_i])
            enl.append(ends[t_i])
    fa, fb = flag_a, flag_b
    seq_b = cur_b
    if ids and ids[0] < 0:
        ids = [-x for x in ids]
    elif not rc_state:
        seq_b = res_b
        fa ^= 32
        fb ^= 16
    fb |= 8
    fa ^= 4
    if fb & 2:
        fa ^= 2
        fb ^= 2
    recs.append(update_scores_se(seq_b, len(seq_b), min_frac, ids, sc, stl,
                                 enl, best2, header_b, fb, alignment_scores,
                                 uniq_alignment_scores))
    if sam_cb is not None:  # mate a unmapped (return 1)
        sam_cb(cur_a, header_a, fa)
    return recs


def aln_frags_force_pe(store: TemplateStore, matched: np.ndarray,
                       codes_a: np.ndarray, codes_b: np.ndarray,
                       header_a: bytes, header_b: bytes, flag_a: int,
                       flag_b: int, arc: bool, kmersize: int, minlen: int,
                       mq: int, scoreT: float, mrc: float, min_frac: float,
                       rew: Penalty, points: Points, alignment_scores,
                       uniq_alignment_scores,
                       sam_cb=None, nat=None) -> List[FragRecord]:
    """alnFragsForcePE (alnfrags.c:1974-2148): a template survives only
    when BOTH mates align to it; combined scores spool as one pair."""
    Wl = -rew.Wl
    n = len(matched)
    rc_a = rc_codes(codes_a)
    rc_b = rc_codes(codes_b)
    np_a = np.flatnonzero(codes_a == 4).astype(np.int64)
    np_ar = np.flatnonzero(rc_a == 4).astype(np.int64)
    np_b = np.flatnonzero(codes_b == 4).astype(np.int64)
    np_br = np.flatnonzero(rc_b == 4).astype(np.int64)

    ids, sc_l, st_l, en_l = [], [], [], []
    best = 0
    flipped = False
    tids = matched.tolist()

    if nat is None:
        nat = _pe_native_stats(store, tids, codes_a, codes_b, arc, mq,
                               rew, minlen=minlen, mrc=mrc)
    if nat is not None:
        sc1, po1, ln1, tg1, qg1, sc2, po2, ln2, tg2, qg2, flp = nat
        flipped = bool(flp[0])
        for t_i in range(n):
            t = abs(tids[t_i])
            t_len = store.get(t).len
            s1, l1 = int(sc1[t_i]), int(ln1[t_i])
            if not (0 < s1 and minlen <= l1
                    and (mrc * len(codes_a) <= l1 - int(qg1[t_i])
                         or mrc * t_len <= l1 - int(tg1[t_i]))):
                continue
            s2, l2 = int(sc2[t_i]), int(ln2[t_i])
            if not (0 < s2 and minlen <= l2
                    and (mrc * len(codes_b) <= l2 - int(qg2[t_i])
                         or mrc * t_len <= l2 - int(tg2[t_i]))):
                continue
            aln_len = l1 + l2
            if int(po1[t_i]) < int(po2[t_i]):
                start = int(po1[t_i])
                end = int(po2[t_i]) + l2 - int(tg2[t_i])
            else:
                start = int(po2[t_i])
                end = int(po1[t_i]) + l1 - int(tg1[t_i])
            read_score = s1 + s2
            if start == 0:
                read_score += Wl
            if end == t_len:
                read_score += Wl
            score = 1.0 * read_score / aln_len
            if read_score > kmersize and score >= scoreT:
                ids.append(t)  # abs stored (alnfrags.c:2105)
                sc_l.append(read_score)
                st_l.append(start)
                en_l.append(end)
                if best < read_score:
                    best = read_score

    for t_i in (range(n) if nat is None else ()):
        template = tids[t_i]
        if template < 0 and not flipped and not arc:
            flipped = True
        t = abs(template)
        tindex = store.get(t)
        t_len = tindex.len
        if arc:
            points.len = 0
            rcres = anker_rc_comp(tindex, codes_a, rc_a, np_a, np_ar,
                                  len(codes_a), 0, len(codes_a), points, 1)
            if rcres < 0:
                cur_a, na = rc_a, np_ar
                cur_b, nb = rc_b, np_br
            elif rcres:
                tids[t_i] = -tids[t_i]
                cur_a, na = codes_a, np_a
                cur_b, nb = codes_b, np_b
            else:
                cur_a = None
        else:
            cur_a = rc_a if flipped else codes_a
            na = np_ar if flipped else np_a
            cur_b = rc_b if flipped else codes_b
            nb = np_br if flipped else np_b
            points.len = 0
        if cur_a is None:
            continue
        st, _, _ = kma_align(tindex, cur_a, len(cur_a), 0, len(cur_a), 0,
                             0, mq, rew, points, kmersize, traceback=False,
                             n_positions=na)
        if not (0 < st.score and minlen <= st.len
                and mrcheck(mrc, st, len(codes_a), t_len)):
            continue
        points.len = 0
        st_r, _, _ = kma_align(tindex, cur_b, len(cur_b), 0, len(cur_b),
                               0, 0, mq, rew, points, kmersize,
                               traceback=False, n_positions=nb)
        if not (0 < st_r.score and minlen <= st_r.len
                and mrcheck(mrc, st_r, len(codes_b), t_len)):
            continue
        aln_len = st.len + st_r.len
        if st.pos < st_r.pos:
            start = st.pos
            end = st_r.pos + st_r.len - st_r.tGaps
        else:
            start = st_r.pos
            end = st.pos + st.len - st.tGaps
        read_score = st.score + st_r.score
        if start == 0:
            read_score += Wl
        if end == t_len:
            read_score += Wl
        score = 1.0 * read_score / aln_len
        if read_score > kmersize and score >= scoreT:
            ids.append(t)  # abs stored (alnfrags.c:2105)
            sc_l.append(read_score)
            st_l.append(start)
            en_l.append(end)
            if best < read_score:
                best = read_score
    if not best:
        if sam_cb is not None:  # both unmapped (alnfrags.c:2147 return 3)
            cu_a = (rc_a if flipped else codes_a) if not arc else codes_a
            cu_b = (rc_b if flipped else codes_b) if not arc else codes_b
            sam_cb(cu_a, header_a, flag_a)
            sam_cb(cu_b, header_b, flag_b)
        return []
    # alnfrags.c:2126-2143: the stored ids are positive, so rc never
    # sets and the final strrc toggles the WORKING orientation once
    # more: non-arc spools the original bytes with a 48-flag toggle iff
    # flipped; arc always toggles flags and spools rc(working) -- the
    # original bytes when the candidate loop left the buffers flipped
    fa, fb = flag_a, flag_b
    seq_a, seq_b = codes_a, codes_b
    if arc:
        if not flipped:
            seq_a, seq_b = rc_a, rc_b
        fa ^= 48
        fb ^= 48
    elif flipped:
        fa ^= 48
        fb ^= 48
    return [update_scores_pe(seq_a, len(seq_a), seq_b, len(seq_b),
                             min_frac, ids, sc_l, st_l, en_l, best,
                             header_a, header_b, fa, fb, alignment_scores,
                             uniq_alignment_scores)]


def _device_enabled(cfg: MapConfig, input_bytes: int = 0) -> bool:
    """Whether the device step-2 scanner should be used (MapConfig.device).

    "auto" turns the device path on only on a GPU backend and for inputs
    of at least KMA_TPU_DEVICE_AUTO_MB (default 256): backend start-up,
    index upload and compilation are paid once per process.  "on" always
    uses the device and fails rather than fall back to the host."""
    if cfg.device == "off":
        return False
    if cfg.device == "on":
        return True
    thresh_mb = int(os.environ.get("KMA_TPU_DEVICE_AUTO_MB", "256"))
    if input_bytes < thresh_mb * (1 << 20):
        return False
    from .devserve import live_daemons
    if live_daemons():
        # a daemon holds the card: asking jax here would start a second
        # backend on it
        return True
    import jax
    return jax.default_backend() == "gpu"


def _device_unsupported(cfg: MapConfig, what: str, err: Exception) -> None:
    """A database the device path cannot take: ``-device on`` ends the
    run with the reason; ``-device auto`` says so once and keeps the
    host scanner."""
    if cfg.device == "on":
        raise DeviceError("-device on: %s cannot run on the device: %s"
                          % (what, err))
    print("# device: %s stays on the host (%s)" % (what, err),
          file=sys.stderr)


class DeviceError(RuntimeError):
    """A ``-device on`` run whose device work failed or cannot start."""


def run_kma(db_prefix: str, output_prefix: str, input_files: List[str],
            cfg: MapConfig, exe_cmd: str = "kma_tpu",
            pe_files: Optional[List[str]] = None,
            int_files: Optional[List[str]] = None,
            shard: Optional[tuple] = None, collect: bool = False):
    """The runKMA flow (runkma.c:130-908) for the -1t1 SE path.

    shard=(pid, nproc) maps only every nproc-th fragment (round-robin by
    global read ordinal) -- the data-parallel axis of the multi-host
    runtime (parallel/multihost.py).  collect=True returns the spool
    records + score arrays instead of running ConClave/output."""
    _t_stage = time.process_time()
    if cfg.deCon:
        # -deCon swaps in .decon.comp.b whose value lists carry the
        # contamination pseudo-template DB_size (kma.c:1489-1493)
        from .index.format import load_comp_b, load_length_b, load_names
        from .index.shm import resolve as _shm_resolve
        idx = load_comp_b(db_prefix + ".decon.comp.b", mmap=cfg.mmap,
                          shm=cfg.shm & 2)
        idx.template_lengths = load_length_b(db_prefix + ".length.b",
                                             shm=cfg.shm)
        idx.names = load_names(db_prefix + ".name", shm=cfg.shm)
        idx.seq_path = _shm_resolve(db_prefix + ".seq.b", cfg.shm & 8)
    else:
        idx = load_index(db_prefix, mmap=cfg.mmap, shm=cfg.shm)
    _db_dt = time.process_time() - _t_stage
    _stage("# Running KMA.")
    db_size = idx.db_size
    contamination = db_size if cfg.deCon else None
    if cfg.deCon:
        # chain scoring touches template_lengths[contamination]; the
        # reference reads one int past its malloc there (kmers.c:168) --
        # a fresh-heap read that is 0 in practice
        idx.template_lengths = np.concatenate(
            [idx.template_lengths, [0]]).astype(idx.template_lengths.dtype)

    def decon_filter(tl):
        """deConPrint (ankers.c:106-124): drop the contamination id via
        find_contamination (first match from the END, back-filled with the
        last element) then find_contamination2 (rc-marked -contamination,
        scanning from the end but stopping at the first positive id)."""
        lst = [int(t) for t in tl]
        for i in range(len(lst) - 1, -1, -1):
            if lst[i] == contamination:
                lst[i] = lst[-1]
                lst.pop()
                break
        for i in range(len(lst) - 1, -1, -1):
            if lst[i] == -contamination:
                lst[i] = lst[-1]
                lst.pop()
                break
            if lst[i] > 0:
                break
        return lst
    template_lengths = idx.template_lengths.astype(np.int64)
    kmersize = cfg.kmersize or int(template_lengths[0])
    if kmersize < 4 or 31 < kmersize:
        kmersize = 16
    names = idx.names

    pen = cfg.penalties
    dmat = pen.score_matrix()
    rew = Penalty(M=pen.M, MM=pen.MM, U=pen.U, W1=pen.W1, Wl=pen.Wl,
                  d=dmat, PE=pen.PE)
    set_preseed_exhaustive(1 if cfg.exhaustive else 0)

    alignment_scores = np.zeros(db_size, dtype=np.int64)
    uniq_alignment_scores = np.zeros(db_size, dtype=np.int64)

    # -proxi plumbing: the scanners always see |minFrac| (kmers.c:133-142);
    # softProxi exists only for mem_mode with a soft (negative) -proxi and
    # later REPLACES alignment_scores (runkma.c:1154-1156).  The alignment
    # stage keeps the raw sign (kma.c:1605,1620); -asm forces the
    # non-mem alignment stage back to 1.0 (kma.c:1622).
    from .mapping.scan import Proxi
    soft_proxi = None
    scan_proxi = None
    scanner_min_frac = -cfg.min_frac \
        if (not cfg.mem_mode and cfg.min_frac < 0) else cfg.min_frac
    if scanner_min_frac < 1.0:
        if scanner_min_frac < 0:
            soft_proxi = np.zeros(db_size + 3, dtype=np.int64)
            scanner_min_frac = -scanner_min_frac
        scan_proxi = Proxi(scanner_min_frac, soft_proxi)
    aln_min_frac = 1.0 if (cfg.preset & 16) and not cfg.mem_mode \
        else cfg.min_frac

    store = TemplateStore(db_prefix + ".seq.b", template_lengths, kmersize)
    scanner = SaveKmersScanner(idx, pen, exhaustive=cfg.exhaustive,
                               proxi=scan_proxi)
    points = Points()

    # --- steps 1-3: trim, scan, align, spool -----------------------------
    # -a: every mapped fragment's pre-ConClave candidates go to
    # .frag_raw.gz as they are produced (updateAllFrag, frags.c:64-184;
    # opened before mapping like runkma.c:269-272)
    frag_raw_out = writers.open_gz(output_prefix + ".frag_raw.gz") \
        if cfg.print_all else None

    def dump_all_frag(codes, best_hits, score, starts, ends, templates,
                      header):
        if frag_raw_out is not None:
            frag_raw_out.write(writers.frag_raw_row(
                codes, best_hits, score, starts, ends, templates, header))

    if collect:
        records: List[FragRecord] = []
    else:
        # -mf bounded spool (conclave.c:196-208): past max_frag records
        # spill to a tmp file instead of growing the heap
        from .assign.conclave import RecordSpool
        records = RecordSpool(cfg.max_frag, tmpdir=cfg.tmp_dir or None)
    # global read ordinal of each record: ConClave consumes records in
    # input-stream order, so the multi-host reducer merge-sorts by these
    rec_ords: List[int] = []
    _pid0, _nproc = (shard[0], shard[1]) if shard else (0, 1)
    _cur_ord = [0]

    def _shard_reads(it):
        """Round-robin fragment ownership over the 'data' axis."""
        for j, r in enumerate(it):
            if j % _nproc == _pid0:
                yield r
    # readNum (savekmers.c:97,182): every post-trim fragment counts, mapped
    # or not; feeds mapstat fragmentCount and the xml query-len
    # (runkma.c:466,484)
    n_frags = 0

    def handle_se_anker(codes, n_positions, rc_flag, templates, header,
                        flag, rc_override=None):
        if contamination is not None:
            templates = decon_filter(templates)
            if not templates:
                return
        q_len = len(codes)
        if kmersize > q_len:
            return
        if cfg.mem_mode:
            handle_mem_anker(codes, rc_flag, templates, header, flag)
            return
        # HMM whole-word slices: the reference's step-3 rc is shifted by
        # one garbage word (see AnkerHit.rc_override)
        codes_r = rc_override if rc_override is not None else rc_codes(codes)
        n_pos = np.asarray(n_positions, dtype=np.int64)
        n_pos_r = np.sort((q_len - 1) - n_pos[::-1]) if len(n_pos) else n_pos
        res = aln_frags_se(store, np.asarray(templates, np.int64), rc_flag,
                           codes, codes_r, n_pos, n_pos_r, header, flag,
                           kmersize, cfg.min_len, cfg.mq, cfg.score_t,
                           cfg.mrc, rew, points, aln_min_frac)
        if res is None:
            if sam_un is not None:
                sam_unmapped(codes, header, flag | 4)
            return
        rec, sel_scores = res
        # global score accumulation (updatescores.c:217-281)
        if rec.best_hits == 1:
            t = abs(rec.templates[0])
            alignment_scores[t] += sel_scores[0]
            uniq_alignment_scores[t] += rec.score
        else:
            for i, t in enumerate(rec.templates):
                alignment_scores[abs(t)] += sel_scores[i]
        records.append(rec)
        rec_ords.append(_cur_ord[0])
        dump_all_frag(rec.codes, rec.best_hits, rec.score, rec.starts,
                      rec.ends, rec.templates, rec.header)

    def handle_mem_anker(codes, rc_flag, templates, header, flag,
                         mate=None):
        """update_Scores_MEM / _pe_MEM (runkma.c:1117-1134,
        updatescores.c:26-107): candidates and score come straight from
        the step-2 anker."""
        n = len(templates)
        best_read_score = abs(int(rc_flag))
        tl = [int(t) for t in templates]
        starts = [0] * n
        ends = [int(template_lengths[abs(t)]) for t in tl]
        best_hits = n
        if rc_flag < 0 and n and tl[-1] > 0:
            best_hits = -n  # Sparse marker (runkma.c:1124-1126)
        score = best_read_score
        if mate is not None:
            m_codes, m_header, m_flag, m_score = mate
            score = best_read_score + m_score
        if n == 1:
            t0 = abs(tl[0])
            alignment_scores[t0] += score
            uniq_alignment_scores[t0] += score
        else:
            for t in tl:
                alignment_scores[abs(t)] += score
        rec = FragRecord(q_len=len(codes), best_hits=best_hits,
                         score=-score if mate is not None else score,
                         header=header, flag=flag, codes=codes,
                         starts=starts, ends=ends, templates=tl)
        if mate is not None:
            rec.mate_codes = m_codes
            rec.mate_header = m_header
            rec.mate_flag = m_flag
        records.append(rec)
        rec_ords.append(_cur_ord[0])
        dump_all_frag(codes, abs(best_hits), best_read_score, starts, ends,
                      tl, header)
        if mate is not None:
            dump_all_frag(m_codes, abs(best_hits), m_score, starts, ends,
                          tl, m_header)

    # sparse DB detection (kmers.c:97-125): a prefix (or "-") DB swaps the
    # scanners; print_ankers_Sparse stores a NEGATIVE rc_flag
    sparse_db = idx.prefix_len != 0 or idx.prefix != 0
    pseudo_db = sparse_db and idx.prefix_len == 0 and not cfg.ck

    # -sam: header goes out BEFORE scanning (runkma.c:172,961); unmapped
    # reads are reported inline from step 2 (savekmers.c:204-251, gated
    # to plain `-sam` by kmers.c:68-71) and step 3 (alnfrags.c:2261-2273)
    if cfg.sam and not collect:
        _sam_init_single(names, template_lengths, exe_cmd, sys.stdout)
    sam_un = sys.stdout if cfg.sam == 1 and not collect else None
    # constant SE flag part (savekmers.c:125-132): non-pseudo DBs mark
    # the unmapped read reverse-complemented
    _un_flag = 4 if pseudo_db else 20

    def sam_unmapped(codes, header, flag):
        from .out.sam import sam_record
        sam_record(codes, header, None, None, [0, flag], sam_un)
    sparse_rev = not (idx.prefix_len == 0 and idx.prefix != 0)

    def _neg(hit):
        hit.rc_flag = -abs(int(hit.rc_flag))
        return hit

    if sparse_db and cfg.one2one and not cfg.ck:
        from .mapping.sparse_scan import (save_kmers_pseudo_sparse,
                                          save_kmers_sparse)
        if pseudo_db:
            def scan_one(read):
                hit = save_kmers_pseudo_sparse(
                    idx, pen, read.codes, read.n_positions, read.header,
                    cfg.exhaustive, scanner.Score, scanner.extendScore,
                    scanner.include, scan_proxi)
                return [_neg(hit)] if hit is not None else []
        else:
            def scan_one(read):
                hit = save_kmers_sparse(idx, pen, read.codes,
                                        read.n_positions, read.header,
                                        cfg.exhaustive, scanner.Score,
                                        scan_proxi)
                return [_neg(hit)] if hit is not None else []
    elif sparse_db:
        # default / -hmm / -ck+1t1 on a sparse DB all land on
        # save_kmers_sparse_chain (kmers.c:110-121)
        from .mapping.chain_scan import sparse_chain_scan_read

        def scan_one(read):
            hits = sparse_chain_scan_read(
                idx, pen, read.codes, read.header, cfg.exhaustive,
                scanner.Score, scanner.extendScore, scanner.include,
                template_lengths, cfg.min_len, cfg.cover_t, cfg.score_t,
                cfg.mrc, cfg.lc, scan_proxi)
            return [_neg(h) for h in hits]
    elif cfg.ck and cfg.one2one:
        # -ck only swaps the SE scanner when -1t1 is set (kma.c:1272-1276)
        from .mapping.scan import save_kmers_count

        def scan_one(read, lookups=None):
            hit = save_kmers_count(idx, pen, read.codes, read.n_positions,
                                   read.header, cfg.exhaustive,
                                   scanner.Score, scanner.Score_r,
                                   scan_proxi, lookups=lookups)
            return [hit] if hit is not None else []
    elif cfg.hmm:
        from .mapping.hmm_scan import HmmCompBuf, hmm_scan_read
        hmm_buf = HmmCompBuf()

        def scan_one(read, lookups=None):
            return hmm_scan_read(
                idx, read.codes, read.header, template_lengths,
                cfg.min_len, scanner.Score, scanner.Score_r,
                scanner.include, mem_mode=cfg.mem_mode, proxi=scan_proxi,
                exhaustive=cfg.exhaustive, decon=cfg.deCon,
                comp_buf=hmm_buf, lookups=lookups)
    elif not cfg.one2one:
        from .mapping.chain_scan import chain_scan_read
        from .mapping.native_chain import make_native_chain

        # native default-mode chainer (native/kma_chain.cpp, an exact
        # port of chain_scan.py); proxi/cmer shapes keep the Python path
        nchain = make_native_chain(idx, pen, template_lengths) \
            if scan_proxi is None else None
        if nchain is not None:
            nchain_batch = nchain

            def scan_one(read):
                return nchain.scan(
                    read.codes, read.header, cfg.exhaustive,
                    scanner.Score, scanner.extendScore, scanner.include,
                    cfg.min_len, cfg.cover_t, cfg.score_t, cfg.mrc,
                    cfg.lc)
        else:
            def scan_one(read):
                return chain_scan_read(
                    idx, pen, read.codes, read.header, cfg.exhaustive,
                    scanner.Score, scanner.extendScore, scanner.include,
                    template_lengths, cfg.min_len, cfg.cover_t,
                    cfg.score_t, cfg.mrc, cfg.lc, scan_proxi)
    else:
        def scan_one(read):
            hit = scanner.scan(read.codes, read.n_positions, read.header)
            return [hit] if hit is not None else []

    qc = None
    if cfg.qc_report:
        from .utils.qc import QCStat
        qc = QCStat(cfg.qc_report - 1)

    # Device step-2 path: the plain -1t1 SE scan batches through the
    # dense device scanner (mapping/scan_dense.py); every other mode keeps
    # the host scanner.  Parity is enforced by tests/test_dense_scan.py and
    # the device e2e test.
    device_stream = None
    _in_bytes = 0
    for _f in list(input_files or []) + list(pe_files or []) \
            + list(int_files or []):
        try:
            _in_bytes += os.path.getsize(_f)
        except OSError:
            pass
    # persistent device session (devserve daemon, the -shm analog): one
    # connection per run serves the dense scan, chain probes and PE
    # lookups without any in-process jax/backend setup
    _dev_client = None
    _use_dev = _device_enabled(cfg, _in_bytes)
    if _use_dev:
        from .devserve import DevClient, live_daemons
        _dev_client = DevClient.connect(db_prefix)
        if _dev_client is not None:
            print("# device: using devserve session", file=sys.stderr)
        elif live_daemons():
            # one process per card: a daemon already holds the device
            held = ("a devserve daemon holds the device (%s) but does not "
                    "serve %s" % (", ".join(live_daemons()), db_prefix))
            if cfg.device == "on":
                raise DeviceError(
                    "%s; stop it (kma devserve -t_db DB -stop) or map "
                    "against its database" % held)
            print("# device: %s; this run stays on the host" % held,
                  file=sys.stderr)
            _use_dev = False
    if (cfg.one2one and not sparse_db and not cfg.ck
            and not (scan_proxi and scan_proxi.soft is not None)
            and _use_dev):
        if _dev_client is not None:
            from .devserve import RemoteDenseScanner
            from .mapping.scan_stream import DeviceScanStream
            device_stream = DeviceScanStream(
                idx, pen, host=scanner,
                dense=RemoteDenseScanner(
                    _dev_client, pen, cfg.exhaustive,
                    scan_proxi.min_frac if scan_proxi else None))
        else:
            try:
                from .mapping.scan_stream import DeviceScanStream
                device_stream = DeviceScanStream(
                    idx, pen, exhaustive=cfg.exhaustive,
                    proxi_frac=scan_proxi.min_frac if scan_proxi else None,
                    host=scanner)
            except NotImplementedError as err:
                _device_unsupported(cfg, "the -1t1 scan", err)
                device_stream = None

    # Batched step-3: buffer step-2 ankers and align them through the
    # threaded native engine (alnfrags.c worker pool analog) instead of
    # one ctypes call per (read, template).
    from .align import native_aln as _nat
    use_batch = _nat.get_lib() is not None and not cfg.mem_mode
    if use_batch:
        # -ca: the batched scorers' chainSeeds variant (chainSeedsPtr
        # role, kma.c:693); set per run, both ways (shared process)
        _nat.get_lib().kaln_set_circular(1 if cfg.circular else 0)

    # device step-3 pre-pass: heavy lead/trail banded windows scored by
    # the banded-NW scorer (align/nw_device.py; nw.c:892 role)
    _nw_dev = None
    if use_batch and _use_dev:
        from .align.nw_device import make_nw_prepass
        _nw_dev = make_nw_prepass(_dev_client,
                                  strict=cfg.device == "on")
    pend: List[tuple] = []
    pord: List[int] = []

    # lazily filled template-id -> native CCI handle map, so the flush
    # staging is one fancy-index instead of a per-pair call
    _handle_cache = np.zeros(idx.db_size + 1, np.uint64)

    def _handles_for(tpl_ids_abs):
        miss = np.unique(tpl_ids_abs[_handle_cache[tpl_ids_abs] == 0])
        for t in miss.tolist():
            _handle_cache[t] = _nat.native_handle(store.get(t))
        return _handle_cache[tpl_ids_abs]

    # --- fused native run driver (native/kma_run.cpp) -------------------
    # The entire scan -> score -> spool -> ConClave hot path in one
    # native call per read batch (reference: the one-process C loop of
    # runkma.c:130-908).  Applies to SE -1t1 / default-chain runs on
    # plain-kmer DBs; every other mode keeps the per-component path
    # below.  KMA_TPU_NO_FUSED=1 forces the unfused pipeline.
    fused = None
    _fused_pe = (not int_files
                 and (not pe_files
                      or (cfg.pair_mode in ("u", "p")
                          and cfg.fpm in ("u", "p"))))
    if (_fused_pe
            and (input_files and input_files != ["--"] or pe_files)
            and not sparse_db and not cfg.ck and not cfg.hmm
            and scan_proxi is None and not cfg.sam
            and not cfg.xml and not cfg.boot and qc is None
            and device_stream is None
            and not os.environ.get("KMA_TPU_NO_FUSED")):
        from .io.seq import detect_format as _detect
        from .io.native_io import get_lib as _io_lib
        _all_files = [f for f in list(input_files or []) if f != "--"] \
            + list(pe_files or [])
        if _io_lib() is not None and _all_files and all(
                _detect(p) == "fastq" for p in _all_files):
            from .run_native import make_run_driver
            fused = make_run_driver(
                idx, pen, template_lengths, store.seq_path, cfg,
                0 if cfg.one2one else 1, aln_min_frac, contamination)
            if fused is not None:
                # -ca: batched step-3 scorers chain circular
                from .run_native import set_circular as _set_circ
                _set_circ(fused._lib, cfg.circular)

    if fused is not None:
        from .io.native_io import iter_fastq_native_batches
        from .io.seq import sniff_phred_scale as _sniff
        _mp = cfg.min_phred
        if _mp < cfg.hardmask_q:  # kma.c:1554-1556
            _mp = cfg.hardmask_q
        if _mp < cfg.min_q:
            _mp = cfg.min_q
        # Multi-file multi-host runs shard ownership by FILE instead of
        # by fragment ordinal: each rank parses ONLY its own files (the
        # duplicated parse+trim of every rank reading the whole stream
        # was the main strong-scaling leak).  Ordinals are fed encoded
        # as (file_idx << 40) | in_file_index; the reducer all-gathers
        # the per-file survivor counts and rebases them to the global
        # input-stream order before the merge (parallel/multihost.py),
        # so ConClave still consumes the reference's stream order.
        _se_list = list(input_files if input_files != ["--"] else [])
        _file_shard = (_nproc > 1 and not pe_files and collect
                       and len(_se_list) > 1)
        if _file_shard:
            _file_counts = np.zeros(len(_se_list), np.int64)
        for fj, path in enumerate(_se_list):
            if _file_shard and fj % _nproc != _pid0:
                continue
            print("%s\t%s" % ("# Reading inputfile: ", path),
                  file=sys.stderr)
            scale = _sniff(path)
            print("# Phred scale:\t%d" % scale, file=sys.stderr)
            for c_f, c_o, h_f, h_o in iter_fastq_native_batches(
                    path, scale, _mp, cfg.min_q, cfg.hardmask_q,
                    cfg.min_len, cfg.max_len):
                nb = len(c_o) - 1
                if _file_shard:
                    ords = ((np.int64(fj) << np.int64(40))
                            + _file_counts[fj]
                            + np.arange(nb, dtype=np.int64))
                    _file_counts[fj] += nb
                    n_frags += nb
                    fused.map_batch(c_f, c_o, h_f, h_o, ords)
                    continue
                ords = np.arange(n_frags, n_frags + nb, dtype=np.int64)
                n_frags += nb
                if _nproc > 1:
                    # round-robin fragment ownership over 'data'
                    keep = np.flatnonzero(ords % _nproc == _pid0)
                    if not len(keep):
                        continue
                    c_f, c_o = _gather_flat(c_f, c_o, keep)
                    h_f, h_o = _gather_flat(h_f, h_o, keep)
                    ords = ords[keep]
                fused.map_batch(c_f, c_o, h_f, h_o, ords)
        if pe_files:
            _pe_dev = None
            if _use_dev:
                from .mapping.pe_device import make_pe_lookup
                _pe_dev = make_pe_lookup(idx, client=_dev_client)
            n_frags = _fused_pe_feed(fused, pe_files, cfg, _mp, n_frags,
                                     dev=_pe_dev,
                                     shard=(_pid0, _nproc))
        if frag_raw_out is not None:
            _fused_frag_raw(fused, dump_all_frag)
    elif input_files and input_files != ["--"] or not (pe_files or int_files):
        reads_it = iter_reads(input_files, min_phred=cfg.min_phred,
                              hardmask_q=cfg.hardmask_q, min_q=cfg.min_q,
                              min_len=cfg.min_len, max_len=cfg.max_len,
                              qc=qc, boot=cfg.boot)
        def flush_aln():
            if not pend:
                return
            import struct as _struct
            nb = len(pend)
            tpl_off = np.zeros(nb + 1, np.int64)
            codes_off = np.zeros(nb + 1, np.int64)
            npos_off = np.zeros(nb + 1, np.int64)
            qb = np.zeros(2 * nb, np.int32)
            arcs = np.zeros(nb, np.uint8)
            crc_off = np.zeros(nb + 1, np.int64)
            ids_l, codes_l, npos_l, crc_l = [], [], [], []
            for i, item in enumerate(pend):
                (codes, n_pos, rc_flag, templates, header, flag) = item[:6]
                rc_override = item[6] if len(item) > 6 else None
                q_len = len(codes)
                q_start, q_end = 0, q_len
                if (len(header) > 2 * 4 + 1
                        and header[len(header) - 2 * 4 - 1] == 0):
                    q_start, q_end = _struct.unpack_from(
                        "<ii", header, len(header) - 8)
                qb[2 * i] = q_start
                qb[2 * i + 1] = q_end
                arcs[i] = 1 if rc_flag < 0 else 0
                codes_l.append(np.ascontiguousarray(codes, np.uint8))
                npos_l.append(np.ascontiguousarray(n_pos, np.int32))
                ids_l.append(np.asarray(templates, np.int32))
                if rc_override is not None:
                    # HMM whole-word-slice rc (AnkerHit.rc_override)
                    crc_l.append(np.ascontiguousarray(rc_override,
                                                      np.uint8))
                tpl_off[i + 1] = tpl_off[i] + len(templates)
                codes_off[i + 1] = codes_off[i] + q_len
                npos_off[i + 1] = npos_off[i] + len(npos_l[-1])
                crc_off[i + 1] = crc_off[i] \
                    + (len(rc_override) if rc_override is not None else 0)
            tpl_ids = np.ascontiguousarray(np.concatenate(ids_l))
            handles = np.ascontiguousarray(
                _handles_for(np.abs(tpl_ids.astype(np.int64))))
            codes_flat = np.concatenate(codes_l)
            npos_flat = (np.concatenate(npos_l) if npos_l
                         else np.zeros(0, np.int32))
            crc_flat = (np.concatenate(crc_l) if crc_l
                        else None)
            npos_flat = np.ascontiguousarray(npos_flat)
            _dev_tables = None
            if _nw_dev is not None:
                _dev_tables = _nw_dev.compute(
                    handles, tpl_ids, tpl_off, codes_flat, codes_off,
                    npos_flat, npos_off, qb, arcs, rew, kmersize,
                    cfg.mq, cfg.score_t, crc_flat,
                    crc_off if crc_l else None)
                if _dev_tables is not None:
                    # armed for the next frags_se_batch call (which
                    # clears it); _dev_tables keeps the arrays alive
                    _nat.set_dev_scores(*_dev_tables)
            nh, best, frac, otpl, ostart, oend, oscore, olen = \
                _nat.frags_se_batch(
                    handles, tpl_ids, tpl_off, codes_flat, codes_off,
                    npos_flat, npos_off, qb, arcs,
                    rew, kmersize, cfg.min_len, cfg.mq, cfg.score_t,
                    cfg.mrc, max(1, cfg.threads),
                    crc_flat=crc_flat,
                    crc_off=crc_off if crc_l else None,
                    min_frac=aln_min_frac)
            for i, item in enumerate(pend):
                (codes, n_pos, rc_flag, templates, header, flag) = item[:6]
                if best[i] <= kmersize:
                    if sam_un is not None:
                        sam_unmapped(codes, header, flag | 4)
                    continue
                b = int(tpl_off[i])
                e = b + int(nh[i])
                rec, sel_scores = update_scores(
                    codes, len(codes), aln_min_frac, int(nh[i]),
                    int(best[i]), float(frac[i]), ostart[b:e].tolist(),
                    oend[b:e].tolist(), otpl[b:e].tolist(),
                    oscore[b:e].tolist(), olen[b:e].tolist(), header,
                    flag)
                if rec.best_hits == 1:
                    t = abs(rec.templates[0])
                    alignment_scores[t] += sel_scores[0]
                    uniq_alignment_scores[t] += rec.score
                else:
                    for j, t in enumerate(rec.templates):
                        alignment_scores[abs(t)] += sel_scores[j]
                records.append(rec)
                rec_ords.append(pord[i])
                dump_all_frag(rec.codes, rec.best_hits, rec.score,
                              rec.starts, rec.ends, rec.templates,
                              rec.header)
            pend.clear()
            pord.clear()

        if device_stream is not None:
            for read, hit in device_stream.stream(_shard_reads(reads_it)):
                n_frags += 1
                _cur_ord[0] = (n_frags - 1) * _nproc + _pid0
                if hit is None:
                    if sam_un is not None:
                        sam_unmapped(read.codes, read.header, _un_flag)
                    continue
                if not use_batch:
                    handle_se_anker(hit.codes, hit.n_positions, hit.rc_flag,
                                    hit.templates, hit.header, hit.flag)
                    continue
                templates = hit.templates
                if contamination is not None:
                    templates = decon_filter(templates)
                    if not templates:
                        continue
                if kmersize > len(hit.codes):
                    continue
                pord.append(_cur_ord[0])
                pend.append((hit.codes, hit.n_positions, hit.rc_flag,
                             templates, hit.header, hit.flag))
                if len(pend) >= 2048:
                    flush_aln()
            flush_aln()
        else:
            # default/chain/HMM/-ck hits batch through the same native
            # aligner (HMM rc_override slices auto-fallback per hit);
            # sparse shapes keep the per-hit path
            batchable = use_batch and not sparse_db

            def _consume(read, hits):
                if not hits and sam_un is not None:
                    sam_unmapped(read.codes, read.header, _un_flag)
                for hit in hits:
                    if not batchable:
                        flush_aln()
                        handle_se_anker(hit.codes, hit.n_positions,
                                        hit.rc_flag, hit.templates,
                                        hit.header, hit.flag,
                                        hit.rc_override)
                        continue
                    templates = hit.templates
                    if contamination is not None:
                        templates = decon_filter(templates)
                        if not templates:
                            continue
                    if kmersize > len(hit.codes):
                        continue
                    pord.append(_cur_ord[0])
                    pend.append((hit.codes, hit.n_positions, hit.rc_flag,
                                 templates, hit.header, hit.flag,
                                 hit.rc_override))
                    if len(pend) >= 2048:
                        flush_aln()

            nchain_b = locals().get("nchain_batch")

            def _bump_ord():
                nonlocal n_frags
                n_frags += 1
                _cur_ord[0] = (n_frags - 1) * _nproc + _pid0

            chain_dev = None
            if nchain_b is not None and _use_dev:
                # device chain scanner: device hash probes feed the native
                # chain splicer (mapping/chain_device.py)
                try:
                    from .mapping.chain_device import DeviceChainStream
                    if _dev_client is not None:
                        chain_dev = DeviceChainStream(
                            idx, pen, template_lengths, nchain_b,
                            lookup=_dev_client.chain_lookup,
                            voff_map=_dev_client.voff_map)
                    else:
                        chain_dev = DeviceChainStream(idx, pen,
                                                      template_lengths,
                                                      nchain_b)
                except NotImplementedError as err:
                    _device_unsupported(cfg, "the chain scan", err)
                    chain_dev = None
            if chain_dev is not None:
                for read, hits in chain_dev.stream(
                        _shard_reads(reads_it), cfg.exhaustive,
                        cfg.min_len, cfg.cover_t, cfg.score_t, cfg.mrc,
                        cfg.lc):
                    _bump_ord()
                    _consume(read, hits)
            elif nchain_b is not None:
                # chunked native scan: one ctypes round-trip per 256
                # reads instead of per read
                chunk: List = []

                def _scan_chunk():
                    hits_all = nchain_b.scan_batch_mt(
                        [r.codes for r in chunk],
                        [r.header for r in chunk], cfg.exhaustive,
                        cfg.min_len, cfg.cover_t, cfg.score_t, cfg.mrc,
                        cfg.lc, max(1, cfg.threads))
                    for r, hits in zip(chunk, hits_all):
                        _bump_ord()
                        _consume(r, hits)
                    chunk.clear()

                chunk_cap = 256 * max(1, cfg.threads)
                for read in _shard_reads(reads_it):
                    chunk.append(read)
                    if len(chunk) >= chunk_cap:
                        _scan_chunk()
                _scan_chunk()
            elif (cfg.hmm or (cfg.ck and cfg.one2one)) \
                    and _dev_client is not None \
                    and idx.kmersize <= 16 and not (idx.flag & 3) \
                    and not sparse_db:
                # device window probes: the daemon's chain op feeds the
                # host HMM seed/extend/carve walk (mapping/hmm_scan.py)
                # or the -ck counting scan (scan.save_kmers_count; reads
                # with Ns keep the host probes inside scan_one)
                from .mapping.hmm_scan import DeviceHmmStream
                _hstream = DeviceHmmStream(idx, _dev_client.chain_lookup,
                                           _dev_client.voff_map)
                for read, hits in _hstream.stream(_shard_reads(reads_it),
                                                  scan_one):
                    n_frags += 1
                    _cur_ord[0] = (n_frags - 1) * _nproc + _pid0
                    _consume(read, hits)
            else:
                for read in _shard_reads(reads_it):
                    n_frags += 1
                    _cur_ord[0] = (n_frags - 1) * _nproc + _pid0
                    _consume(read, scan_one(read))
            flush_aln()

    def _pair_stream():
        from .io.pipeline import iter_read_pairs
        if pe_files:
            yield from iter_read_pairs(pe_files, min_phred=cfg.min_phred,
                                       hardmask_q=cfg.hardmask_q,
                                       min_q=cfg.min_q,
                                       min_len=cfg.min_len,
                                       max_len=cfg.max_len, qc=qc)
        if int_files:
            yield from iter_read_pairs(int_files, min_phred=cfg.min_phred,
                                       hardmask_q=cfg.hardmask_q,
                                       min_q=cfg.min_q,
                                       min_len=cfg.min_len,
                                       max_len=cfg.max_len, qc=qc,
                                       interleaved=True)

    if (pe_files or int_files) and fused is None:
        from .mapping.pair import (save_kmers_force_pair,
                                   save_kmers_penalty_pair,
                                   save_kmers_union_pair)
        scan_pair = {"u": save_kmers_union_pair,
                     "p": save_kmers_penalty_pair,
                     "f": save_kmers_force_pair}[cfg.pair_mode]
        pair_inner = None
        if cfg.ck:
            from .mapping.pair import get_kmers_for_pair_count
            pair_inner = get_kmers_for_pair_count
        if sparse_db:
            # kmers.c:108-124 replaces the pair scorer for sparse DBs
            from .mapping.sparse_scan import (
                get_kmers_for_pair_pseudo_sparse, get_kmers_for_pair_sparse)
            pair_inner = get_kmers_for_pair_pseudo_sparse if pseudo_db \
                else get_kmers_for_pair_sparse

        def _se_fallback(r):
            hits = scan_one(r)
            if not hits and sam_un is not None:
                sam_unmapped(r.codes, r.header, _un_flag)
            for hit in hits:
                handle_se_anker(hit.codes, hit.n_positions, hit.rc_flag,
                                hit.templates, hit.header, hit.flag,
                                hit.rc_override)

        def _aln_pair(tl, c_a, c_b, h_a, h_b, f_a, f_b, arc, nat):
            if cfg.fpm == "p":
                recs = aln_frags_penalty_pe(
                    store, np.asarray(tl, np.int64), c_a, c_b,
                    h_a, h_b, f_a, f_b, arc, kmersize,
                    cfg.min_len, cfg.mq, cfg.score_t, cfg.mrc,
                    cfg.min_frac, rew, points, alignment_scores,
                    uniq_alignment_scores,
                    sam_cb=sam_unmapped if sam_un is not None else None,
                    nat=nat)
            elif cfg.fpm == "f":
                recs = aln_frags_force_pe(
                    store, np.asarray(tl, np.int64), c_a, c_b,
                    h_a, h_b, f_a, f_b, arc, kmersize,
                    cfg.min_len, cfg.mq, cfg.score_t, cfg.mrc,
                    cfg.min_frac, rew, points, alignment_scores,
                    uniq_alignment_scores,
                    sam_cb=sam_unmapped if sam_un is not None else None,
                    nat=nat)
            else:
                recs = aln_frags_union_pe(
                    store, np.asarray(tl, np.int64), c_a, c_b,
                    h_a, h_b, f_a, f_b, kmersize, cfg.min_len,
                    cfg.mq, cfg.score_t, cfg.mrc, cfg.min_frac,
                    rew, points, alignment_scores,
                    uniq_alignment_scores, arc=arc,
                    sam_cb=sam_unmapped if sam_un is not None else None,
                    nat=nat)
            records.extend(recs)
            rec_ords.extend([_cur_ord[0]] * len(recs))
            for rec in recs:
                dump_all_frag(rec.codes, abs(rec.best_hits),
                              abs(rec.score), rec.starts, rec.ends,
                              rec.templates, rec.header)
                if rec.mate_codes is not None:
                    dump_all_frag(rec.mate_codes, abs(rec.best_hits),
                                  abs(rec.score), rec.starts, rec.ends,
                                  rec.templates, rec.mate_header)

        pe_batchable = (use_batch and not sparse_db
                        and _nat.get_lib() is not None)
        pe_pend: List[tuple] = []

        def flush_pe():
            """Batched PE mate scoring (one threaded native call),
            then the per-pair combiners in spool order."""
            if not pe_pend:
                return
            m = len(pe_pend)
            tploff = np.zeros(m + 1, np.int64)
            a_off = np.zeros(m + 1, np.int64)
            b_off = np.zeros(m + 1, np.int64)
            arcs = np.zeros(m, np.uint8)
            ids_l, a_l, b_l = [], [], []
            for i2, (tl, c_a, c_b, _h1, _h2, _f1, _f2, arc,
                     _o) in enumerate(pe_pend):
                ids_l.append(np.asarray(tl, np.int32))
                tploff[i2 + 1] = tploff[i2] + len(tl)
                a_l.append(np.ascontiguousarray(c_a, np.uint8))
                b_l.append(np.ascontiguousarray(c_b, np.uint8))
                a_off[i2 + 1] = a_off[i2] + len(c_a)
                b_off[i2 + 1] = b_off[i2] + len(c_b)
                arcs[i2] = 1 if arc else 0
            tpl = np.ascontiguousarray(np.concatenate(ids_l))
            handles = np.ascontiguousarray(
                _handles_for(np.abs(tpl.astype(np.int64))))
            a_flat = np.concatenate(a_l)
            b_flat = np.concatenate(b_l)
            outs = _nat.pe_score_batch(handles, tpl, tploff, a_flat,
                                       a_off, b_flat, b_off, arcs, rew,
                                       cfg.mq, max(1, cfg.threads))
            sc1, po1, ln1, tg1, qg1, sc2, po2, ln2, tg2, qg2, flp = outs
            saved_ord = _cur_ord[0]
            for i2, (tl, c_a, c_b, h_a, h_b, f_a, f_b, arc,
                     ordv) in enumerate(pe_pend):
                a0, a1 = int(tploff[i2]), int(tploff[i2 + 1])
                nat_i = (sc1[a0:a1], po1[a0:a1], ln1[a0:a1], tg1[a0:a1],
                         qg1[a0:a1], sc2[a0:a1], po2[a0:a1], ln2[a0:a1],
                         tg2[a0:a1], qg2[a0:a1], flp[i2:i2 + 1])
                _cur_ord[0] = ordv
                _aln_pair(tpl[a0:a1], c_a, c_b, h_a, h_b, f_a, f_b, arc,
                          nat_i)
            _cur_ord[0] = saved_ord
            pe_pend.clear()

        for r1, r2 in _shard_reads(_pair_stream()):
            n_frags += 1
            _cur_ord[0] = (n_frags - 1) * _nproc + _pid0
            if r2 is None:
                flush_pe()
                _se_fallback(r1)
                continue
            if len(r1.codes) < kmersize or len(r2.codes) < kmersize:
                # reference maps the longer-enough mate alone via loadFsa
                # pairing rules; treat short mates as SE of the other
                flush_pe()
                for r in (r1, r2):
                    if len(r.codes) >= kmersize:
                        _se_fallback(r)
                continue
            pa = scan_pair(
                idx, pen, r1.codes, r2.codes, r1.header, r2.header,
                cfg.exhaustive, scanner.Score, scanner.Score_r,
                scanner.extendScore, scanner.include, proxi=scan_proxi,
                pair_fn=pair_inner, rev=sparse_rev)
            if sam_un is not None and pa is not None and pa.unmapped:
                # PE unmapped flags (savekmers.c:205-247)
                um = pa.unmapped
                force = cfg.pair_mode == "f"
                if um & 1:
                    fl = 4 | 65
                    if (um & 2) or force:
                        fl |= 8
                    if not pseudo_db:
                        fl |= 16
                        if (fl & 8) and (um & 2):
                            fl |= 32
                    # the pair scan leaves the unmapped mate RC'd
                    # (comp_rc, savekmers.c:471); pseudo-sparse stays fw
                    sam_unmapped(r1.codes if pseudo_db
                                 else rc_codes(r1.codes), r1.header, fl)
                if (um & 2) or (force and (um & 1)):
                    fl = 4 | 129
                    if um & 1:
                        fl |= 8
                    if not pseudo_db:
                        if um & 2:
                            fl |= 16
                        if fl & 8:
                            fl |= 32
                    # force-pair partner emission (mate2 actually mapped,
                    # um&1 only): the scan printed mate2 and left it FW;
                    # a genuinely unmapped mate2 stays scan-RC'd
                    if pseudo_db or not (um & 2):
                        seq2 = r2.codes
                    else:
                        seq2 = rc_codes(r2.codes)
                    sam_unmapped(seq2, r2.header, fl)
            if pa is None or not pa.records:
                continue
            if sparse_db:
                # print_ankers_Sparse stores -abs(rc_flag) per record
                pa.records = [(c, npx, -abs(int(sc)), tl, h, f)
                              for (c, npx, sc, tl, h, f) in pa.records]
            if len(pa.records) == 2 and len(pa.records[0][3]) == 0:
                # proper pair: record1 has 0 templates (printPair)
                c_a, np_a, sc_a, _t0, h_a, f_a = pa.records[0]
                c_b, np_b, sc_b, tl, h_b, f_b = pa.records[1]
                if contamination is not None:
                    # deConPrintPair (ankers.c:126-148): one filter over
                    # the shared list; empty drops BOTH mates
                    tl = decon_filter(tl)
                    if not tl:
                        continue
                if cfg.mem_mode:
                    flush_pe()
                    if kmersize <= len(c_a):
                        if kmersize <= len(c_b):
                            handle_mem_anker(c_a, sc_a, tl, h_a, f_a,
                                             mate=(c_b, h_b, f_b,
                                                   abs(int(sc_b))))
                        else:
                            handle_mem_anker(c_a, sc_a, tl, h_a, f_a)
                    continue
                if kmersize <= len(c_a) and kmersize <= len(c_b):
                    if pe_batchable:
                        pe_pend.append((list(tl), c_a, c_b, h_a, h_b,
                                        f_a, f_b, int(sc_a) < 0,
                                        _cur_ord[0]))
                        if len(pe_pend) >= 512:
                            flush_pe()
                    else:
                        _aln_pair(tl, c_a, c_b, h_a, h_b, f_a, f_b,
                                  int(sc_a) < 0, None)
                continue
            flush_pe()
            for (c, npos_, sc, tl, h, f) in pa.records:
                handle_se_anker(c, npos_, sc, tl, h, f)
        flush_pe()

    if qc is not None:
        from .utils.qc import print_qcstat
        with open(output_prefix + ".json", "w") as jf:
            print_qcstat(qc, cfg.min_q, max(cfg.min_phred, cfg.hardmask_q),
                         cfg.hardmask_q, cfg.min_len, cfg.max_len,
                         cfg.five_clip, cfg.three_clip, jf)

    if frag_raw_out is not None:
        frag_raw_out.close()
    tot_frags = n_frags
    if soft_proxi is not None:
        # soft -proxi in mem_mode: the scanner's softProxi totals REPLACE
        # alignment_scores before ConClave (runkma.c:1154-1156)
        alignment_scores[:] = soft_proxi[:db_size]
    if collect:
        out = {"alignment_scores": alignment_scores,
               "uniq_alignment_scores": uniq_alignment_scores,
               "tot_frags": n_frags, "db_size": db_size,
               "template_lengths": template_lengths, "names": names,
               "store": store, "rew": rew, "points": points,
               "kmersize": kmersize, "ndrv": None, "spool": None,
               "records": None, "rec_ords": None,
               "file_frag_counts": None}
        if fused is not None:
            try:
                if _file_shard:
                    out["file_frag_counts"] = _file_counts
            except NameError:
                pass
            # fast path: hand the native driver + raw spool arrays to the
            # multihost reducer (no Python record conversion)
            a, u = fused.scores()
            alignment_scores[:] = a
            uniq_alignment_scores[:] = u
            out["ndrv"] = fused
            out["spool"] = fused.spool_export()
        else:
            out["records"] = records
            out["rec_ords"] = rec_ords
        return out
    if device_stream is not None or _nw_dev is not None:
        # what the device did in this run (read by chip_smoke.py)
        print("# device counters: scan_batches=%d nw_windows=%d "
              "nw_dispatches=%d"
              % (device_stream.batches if device_stream is not None else 0,
                 _nw_dev.windows_scored if _nw_dev is not None else 0,
                 _nw_dev.dispatches if _nw_dev is not None else 0),
              file=sys.stderr)
    # stage lines in the reference's kmaPipe order; -status switches to
    # the forked-pipe TIMED variants (kmers.c:267/269, runkma.c:554-560)
    _map_dt = time.process_time() - _t_stage
    _stage("#\n# Total number of query fragment after trimming:\t%d\n#"
           % n_frags)
    if cfg.status:
        _stage("# Total time used for converting query: %.2f s.\n#"
               % _map_dt)
    else:
        _stage("# Query converted\n#")
    _stage("#\n# Total time used for DB loading: %.2f s.\n#" % _db_dt)
    _stage("# Finding k-mer ankers")
    if cfg.status:
        _stage("#\n# Total time used ankering query: %.2f s.\n#"
               % _map_dt)
        _stage("#\n# KMA mapping time\t%.2f s." % _map_dt)
        _stage("#\n# Sort, output and select KMA alignments.")
    else:
        _stage("# Query ankered\n#")
        _stage("# KMA mapping done\n#")
        _stage("# Sort, output and select KMA alignments.")
    return _conclave_and_output(
        records, db_size, template_lengths,
        lambda t: names[t - 1].decode("latin1"), store, alignment_scores,
        uniq_alignment_scores, cfg, rew, points, kmersize, db_prefix,
        output_prefix, exe_cmd, tot_frags,
        sam_init=None,  # header already written before scanning
        ndrv=fused)


def _sam_init_single(names, template_lengths, exe_cmd, out):
    from .out.sam import sam_header
    sam_header(names, template_lengths, exe_cmd, out)


def _gather_flat(flat, off, keep):
    """Sub-batch (flat, off) for the kept item indices (vectorized)."""
    lens = np.diff(off)
    kl = lens[keep]
    total = int(kl.sum())
    starts = off[:-1][keep]
    if total:
        base = np.repeat(starts, kl)
        rel = np.arange(total, dtype=np.int64) \
            - np.repeat(np.cumsum(kl) - kl, kl)
        out = np.ascontiguousarray(np.asarray(flat)[base + rel])
    else:
        out = np.zeros(0, np.uint8)
    noff = np.zeros(len(keep) + 1, np.int64)
    np.cumsum(kl, out=noff[1:])
    return out, noff


def _fused_collect_records(fused):
    """Native spool -> (FragRecord list, ords) for the multihost merge
    (parallel/multihost.py consumes the same shapes the Python spool
    produced)."""
    (q_len, best_hits, score, flag, ordv, tpl, starts, ends, t_off, cod,
     cod_off, hdr, hdr_off, mcod, mcod_off, mhdr, mhdr_off,
     mflag) = fused.spool_export()
    records = []
    for i in range(len(q_len)):
        b, e = int(t_off[i]), int(t_off[i + 1])
        rec = FragRecord(
            q_len=int(q_len[i]), best_hits=int(best_hits[i]),
            score=int(score[i]),
            header=hdr[hdr_off[i]:hdr_off[i + 1]].tobytes(),
            flag=int(flag[i]),
            codes=cod[cod_off[i]:cod_off[i + 1]].copy(),
            starts=starts[b:e].tolist(), ends=ends[b:e].tolist(),
            templates=tpl[b:e].tolist())
        if score[i] < 0:
            rec.mate_codes = mcod[mcod_off[i]:mcod_off[i + 1]].copy()
            rec.mate_header = mhdr[mhdr_off[i]:mhdr_off[i + 1]].tobytes()
            rec.mate_flag = int(mflag[i])
        records.append(rec)
    return records, ordv.tolist()


def _res_gate(read_score, t_len, template_tot_ulen, Nhits, cfg, cmp):
    """The .res significance gate (runkma.c:770-783), long-double exact.
    Returns (expected, q_value, p_value, passed)."""
    ld = np.longdouble
    expected = ld(t_len) / ld(max(1, (template_tot_ulen - t_len))) \
        * ld(Nhits - read_score)
    if 0 < expected:
        q_value = ((ld(read_score) - expected)
                   / (expected + ld(read_score))
                   * (ld(read_score) - expected))
    else:
        q_value = ld(read_score)
    p_value = p_chisqr(q_value)
    passed = cmp(p_value <= cfg.evalue and read_score > expected,
                 read_score >= cfg.score_t * t_len)
    return expected, q_value, p_value, passed


def _fused_frag_raw(fused, dump_all_frag) -> None:
    """-a rows from the native spool (updateAllFrag, frags.c:64-184):
    record order equals production order, so post-hoc iteration writes
    identical .frag_raw.gz content (PE mate rows included)."""
    (q_len, best_hits, score, flag, _ordv, tpl, starts, ends, t_off, cod,
     cod_off, hdr, hdr_off, mcod, mcod_off, mhdr, mhdr_off,
     _mflag) = fused.spool_export()
    for i in range(len(q_len)):
        b, e = int(t_off[i]), int(t_off[i + 1])
        bh = abs(int(best_hits[i]))
        sc = abs(int(score[i]))
        dump_all_frag(cod[cod_off[i]:cod_off[i + 1]], bh, sc,
                      starts[b:e].tolist(), ends[b:e].tolist(),
                      tpl[b:e].tolist(),
                      hdr[hdr_off[i]:hdr_off[i + 1]].tobytes())
        if score[i] < 0:
            dump_all_frag(mcod[mcod_off[i]:mcod_off[i + 1]], bh, sc,
                          starts[b:e].tolist(), ends[b:e].tolist(),
                          tpl[b:e].tolist(),
                          mhdr[mhdr_off[i]:mhdr_off[i + 1]].tobytes())


def _fused_pe_feed(fused, pe_files, cfg, mp, n_frags, dev=None,
                   shard=(0, 1)) -> int:
    """Aligned PE item batches from two emit-all native streams into
    krun_map_pe_batch (run_input_PE lockstep, runinput.c:463-606)."""
    from .io.native_io import iter_fastq_native_pe_batches
    from .io.seq import sniff_phred_scale as _sniff
    pm = {"u": 0, "p": 1}[cfg.pair_mode]
    fpm = {"u": 0, "p": 1}[cfg.fpm]

    class _Buf:
        def __init__(self, gen):
            self.gen = gen
            self.cur = None
            self.pos = 0

        def pull(self):
            if self.cur is not None and self.pos < len(self.cur[4]):
                return True
            try:
                self.cur = next(self.gen)
                self.pos = 0
                return True
            except StopIteration:
                self.cur = None
                return False

        def avail(self):
            return len(self.cur[4]) - self.pos if self.cur is not None \
                else 0

    for fi in range(0, len(pe_files), 2):
        f1, f2 = pe_files[fi], pe_files[fi + 1]
        print("%s\t%s %s" % ("# Reading inputfile: ", f1, f2),
              file=sys.stderr)
        scale = _sniff(f1) or _sniff(f2)
        print("# Phred scale:\t%d" % scale, file=sys.stderr)
        args = (scale, mp, cfg.min_q, cfg.hardmask_q, cfg.min_len,
                cfg.max_len)
        b1 = _Buf(iter_fastq_native_pe_batches(f1, *args))
        b2 = _Buf(iter_fastq_native_pe_batches(f2, *args))
        while b1.pull() and b2.pull():
            n = min(b1.avail(), b2.avail())
            c1, o1, h1, ho1, p1 = b1.cur
            c2, o2, h2, ho2, p2 = b2.cur
            i1, i2 = b1.pos, b2.pos
            s1 = p1[i1:i1 + n].astype(bool)
            s2 = p2[i2:i2 + n].astype(bool)
            keep = s1 | s2
            nk = int(keep.sum())
            if nk:
                ords = np.arange(n_frags, n_frags + nk, dtype=np.int64)
                n_frags += nk
                pid0, nproc = shard
                if nproc > 1:
                    # round-robin pair ownership over 'data' (ordinals
                    # count every surviving pair globally)
                    own = ords % nproc == pid0
                    kidx = np.flatnonzero(keep)
                    keep = keep.copy()
                    keep[kidx[~own]] = False
                    s1 = s1 & keep
                    s2 = s2 & keep
                    ords = ords[own]
                    nk = int(keep.sum())
                if nk == 0:
                    pass
                elif keep.all() and s1.all() and s2.all():
                    # common case: both streams fully passed; zero-copy
                    ao_ = np.ascontiguousarray(o1[i1:i1 + n + 1])
                    bo_ = np.ascontiguousarray(o2[i2:i2 + n + 1])
                    a_view = c1[ao_[0]:]
                    b_view = c2[bo_[0]:]
                    a_reb = ao_ - ao_[0]
                    b_reb = bo_ - bo_[0]
                    voffs = None
                    if dev is not None:
                        # device PE probes (savekmers.c:427-688 lookups)
                        vaf, var, stride = dev.voffs(a_view, a_reb)
                        vbf, vbr, _ = dev.voffs(b_view, b_reb)
                        voffs = (vaf, var, vbf, vbr, stride)
                    fused.map_pe_batch(
                        a_view, a_reb,
                        h1, np.ascontiguousarray(ho1[i1:i1 + n + 1]),
                        b_view, b_reb,
                        h2, np.ascontiguousarray(ho2[i2:i2 + n + 1]),
                        np.ones(n, np.uint8), ords, pm, fpm,
                        voffs=voffs)
                else:
                    # mixed batch: surviving mate becomes "a"
                    a_c, a_h, b_c, b_h = [], [], [], []
                    bp = np.zeros(nk, np.uint8)
                    j = 0
                    for t in range(n):
                        if not keep[t]:
                            continue
                        if s1[t]:
                            a_c.append(c1[o1[i1 + t]:o1[i1 + t + 1]])
                            a_h.append(h1[ho1[i1 + t]:ho1[i1 + t + 1]])
                            if s2[t]:
                                b_c.append(c2[o2[i2 + t]:o2[i2 + t + 1]])
                                b_h.append(h2[ho2[i2 + t]:ho2[i2 + t + 1]])
                                bp[j] = 1
                            else:
                                b_c.append(c2[:0])
                                b_h.append(h2[:0])
                        else:
                            a_c.append(c2[o2[i2 + t]:o2[i2 + t + 1]])
                            a_h.append(h2[ho2[i2 + t]:ho2[i2 + t + 1]])
                            b_c.append(c1[:0])
                            b_h.append(h1[:0])
                        j += 1

                    def _flat(parts):
                        off = np.zeros(len(parts) + 1, np.int64)
                        for q, part in enumerate(parts):
                            off[q + 1] = off[q] + len(part)
                        return (np.concatenate(parts) if parts
                                else np.zeros(0, np.uint8)), off
                    af, ao = _flat(a_c)
                    hf, hof = _flat(a_h)
                    bf, bo = _flat(b_c)
                    bhf, bho = _flat(b_h)
                    voffs = None
                    if dev is not None:
                        vaf, var, stride = dev.voffs(af, ao)
                        vbf, vbr, _ = dev.voffs(bf, bo)
                        voffs = (vaf, var, vbf, vbr, stride)
                    fused.map_pe_batch(af, ao, hf, hof, bf, bo, bhf, bho,
                                       bp, ords, pm, fpm, voffs=voffs)
            b1.pos += n
            b2.pos += n
    return n_frags


def _conclave_and_output(records, db_size, template_lengths, name_of, store,
                         alignment_scores, uniq_alignment_scores, cfg, rew,
                         points, kmersize, db_prefix, output_prefix, exe_cmd,
                         tot_frags, sam_init=None, splt=None,
                         ndrv=None) -> int:
    """ConClave + per-template assembly + output stage, shared between
    runKMA (runkma.c:560-908) and the spltDB reducer (spltdb.c:844-1293).

    ``splt`` carries the reducer-only variations: per-shard seq files,
    boundary dummy templates, the databases header line, and the
    trailing-count fragmentCount quirk.
    """
    _t_sort = time.process_time()
    # --- device pileup (assembly.c:1446-1497 on the device) --------------
    # Dense assembly's count scatter rides the devserve session when one
    # is live: the native frag loop exports the accepted aligned rows
    # and the daemon's pileup op returns the delta matrix
    # (ops/pileup.pileup_delta semantics, bit-equal to alnToMatDense).
    _dev_pileup = None
    if cfg.dense and _device_enabled(cfg):
        from .devserve import DevClient as _DPC
        _pcli = _DPC.connect(db_prefix)
        if _pcli is not None:
            from .ops import pileup as _plp

            def _dev_pileup(t_flat, q_flat, offs, starts, t_len,
                            _c=_pcli):
                _plp.DELTA_STATS["calls"] += 1
                _plp.DELTA_STATS["rows"] += len(offs) - 1
                return _c.pileup(t_flat, q_flat, offs, starts, t_len)

            print("# device: pileup via devserve session",
                  file=sys.stderr)
    # --- ConClave --------------------------------------------------------
    w_scores = np.zeros(db_size, dtype=np.int64)
    need_counts = bool(cfg.tsv or cfg.xml) or cfg.sasm or True
    fragment_counts = np.zeros(db_size, dtype=np.int64)
    read_counts = np.zeros(db_size, dtype=np.int64)
    template_tot_ulen = int(template_lengths[1:db_size].sum())
    frag_lists = None
    if ndrv is not None:
        # fused driver: native ConClave over the native spool; copy the
        # (post-pass-B) score arrays out for the output columns
        w_scores, fragment_counts, read_counts = ndrv.conclave(
            cfg.conclave, cfg.lc, template_tot_ulen, cfg.score_t,
            cfg.evalue, cfg.cmp_mode, cfg.max_frag)
        a, u = ndrv.scores()
        alignment_scores[:] = a
        uniq_alignment_scores[:] = u
    elif cfg.conclave == 2:
        from .assign.conclave import run_conclave2
        frag_lists = run_conclave2(
            records, db_size, alignment_scores, uniq_alignment_scores,
            template_lengths, w_scores, template_tot_ulen, cfg.score_t,
            cfg.evalue, CMP[cfg.cmp_mode], fragment_counts, read_counts,
            lc=cfg.lc, max_frag=cfg.max_frag, tmpdir=cfg.tmp_dir or None)
    else:
        frag_lists = run_conclave1(records, db_size, alignment_scores,
                                   uniq_alignment_scores, template_lengths,
                                   w_scores, fragment_counts, read_counts,
                                   lc=cfg.lc, max_frag=cfg.max_frag,
                                   tmpdir=cfg.tmp_dir or None)

    Nhits = int(w_scores[1:].sum()) or 1
    _stage("# Total time for sorting and outputting KMA alignment\t%.2f s."
           % (time.process_time() - _t_sort))
    _stage("#\n# Doing local assemblies of found templates, and output "
           "results")
    _t_asm = time.process_time()

    # ---- native output fast path: the whole per-template loop below in
    # one C call when only the plain .res/.fsa/.aln/.frag.gz set is
    # requested (runkma.c:763-863 as one loop)
    if (ndrv is not None and splt is None
            and not cfg.sasm and not cfg.dense and not cfg.verbose
            and not (cfg.tsv or cfg.xml or cfg.sam)
            and cfg.ID_t != 0.0):
        from .assemble import native_assem as _na
        names = [b""] + [name_of(t).encode("latin1")
                         for t in range(1, db_size)]
        want_fsa = (cfg.nc & 1) == 0 or (cfg.nc & 2) == 0
        want_aln = (cfg.nc & 2) == 0
        res_b, fsa_b, aln_b, frag_b, mat_b, vcf_b, ef_b = ndrv.output_all(
            w_scores, names, cfg, rew.Wl, template_tot_ulen, Nhits,
            cfg.bcd, _na.BASE_CALLERS[cfg.base_caller],
            _na.SIGNIFICANTS[cfg.significant], CMP_CODE[cfg.cmp_mode],
            want_fsa, want_aln, not cfg.nf,
            want_matrix=cfg.print_matrix, vcf_filt=cfg.vcf,
            want_ef=cfg.ef, fragment_counts=fragment_counts,
            read_counts=read_counts)
        with open(output_prefix + ".res", "w") as f:
            f.write(writers.RES_HEADER)
            f.write(res_b.decode("latin1"))
        if want_fsa:
            with open(output_prefix + ".fsa", "wb") as f:
                f.write(fsa_b)
        if want_aln:
            with open(output_prefix + ".aln", "wb") as f:
                f.write(aln_b)
        if not cfg.nf:
            with writers.open_gz(output_prefix + ".frag.gz") as f:
                f.write(frag_b)
        if cfg.print_matrix:
            with writers.open_gz(output_prefix + ".mat.gz") as f:
                f.write(mat_b)
        if cfg.vcf:
            from .out.vcf import vcf_header
            with writers.open_gz(output_prefix + ".vcf.gz") as f:
                f.write(vcf_header(db_prefix))
                f.write(vcf_b)
        if cfg.ef:
            with open(output_prefix + ".mapstat", "wb") as f:
                f.write(writers.mapstat_header(
                    os.path.basename(db_prefix), tot_frags,
                    exe_cmd).encode("latin1"))
                f.write(ef_b)
        _stage("# Total time used for local assembly: %.2f s.\n#"
               % (time.process_time() - _t_asm))
        _stage("# Closing files")
        return 0
    if cfg.verbose:
        _stage("# Template\tScore\tProgress")
    _v_counter = 0

    # --- outputs ---------------------------------------------------------
    res_out = open(output_prefix + ".res", "w")
    res_out.write(writers.RES_HEADER)
    fsa_out = aln_out = None
    if (cfg.nc & 1) == 0:
        fsa_out = open(output_prefix + ".fsa", "w")
    if (cfg.nc & 2) == 0:
        aln_out = open(output_prefix + ".aln", "w")
        if fsa_out is None:
            fsa_out = open(output_prefix + ".fsa", "w")
    frag_out = None if cfg.nf else writers.open_gz(output_prefix + ".frag.gz")
    matrix_out = (writers.open_gz(output_prefix + ".mat.gz")
                  if cfg.print_matrix else None)
    vcf_out = None
    if cfg.vcf:
        from .out.vcf import vcf_header
        vcf_out = writers.open_gz(output_prefix + ".vcf.gz")
        # spltdb.c:909-911 initialises the vcf with a NULL template name
        vcf_out.write(vcf_header(None if splt is not None else db_prefix))
    mapstat_out = None
    if cfg.ef:
        mapstat_out = open(output_prefix + ".mapstat", "w")
        if splt is not None:
            # spltdb.c:576-593 then :805-807 -- databases list, and
            # fragmentCount printed from stream 0's trailing counter
            # (readNum - 1); the column header drops the two *Aln columns
            mapstat_out.write(writers.mapstat_header_splt(
                splt["db_names"], exe_cmd, splt["fragment_count"]))
        else:
            mapstat_out.write(writers.mapstat_header(
                os.path.basename(db_prefix), tot_frags, exe_cmd))
    tsv_out = None
    if cfg.tsv:
        tsv_out = open(output_prefix + ".tsv", "w")
        tsv_out.write(tsv_headerline(cfg.tsv))
    sam_out = sys.stdout if cfg.sam else None
    if sam_out is not None and sam_init is not None:
        sam_init(sam_out)
    xml_out = None
    xml_writer = None
    seqin_size = 0
    if cfg.xml:
        from .out.xmlout import XmlHitWriter, xml_init
        xml_out = sys.stdout if cfg.xml == 2 \
            else open(output_prefix + ".xml", "w")
        if splt is not None:
            # spltdb.c:598-608: first shard's name; the query-len field is
            # **targetInfo read before initialisation (reference UB)
            xml_init(xml_out, os.path.basename(splt["db_names"][0]), 0,
                     exe_cmd, int(time.time()))
        else:
            xml_init(xml_out, db_prefix, tot_frags, exe_cmd,
                     int(time.time()))
        xml_writer = XmlHitWriter(xml_out, rew)
        if splt is None:
            seqin_size = 4 * os.path.getsize(db_prefix + ".seq.b")

    cmp = CMP[cfg.cmp_mode]
    status = 0

    boundary = splt["boundary"] if splt is not None else frozenset()

    # --- assembly per template (runkma.c:763-863) ------------------------
    for template in range(1, db_size):
        if template in boundary:
            # spltdb.c:1104-1129: shard-boundary dummy template -- swap of
            # seq/name streams only, never assembled
            continue
        if w_scores[template] <= 0:
            continue
        if cfg.verbose:
            # runkma.c:765-767 progress rows
            _v_counter += int(w_scores[template])
            _stage("# %d / %d\t%d\t%3d%%" % (template, db_size,
                                               int(w_scores[template]),
                                               100 * _v_counter // Nhits))
        if splt is not None and cfg.xml:
            seqin_size = splt["seqin_sizes"][_shard_of(
                splt["biases"], template)]
        read_score = int(w_scores[template])
        t_len = int(template_lengths[template])
        expected, q_value, p_value, _passed = _res_gate(
            read_score, t_len, template_tot_ulen, Nhits, cfg, cmp)
        name = name_of(template)
        if not _passed:
            # runkma.c:835-857: the failed gate still drains frags
            # through skip_assemble for -sam, and -ID 0 prints a
            # zero-identity row from the mapping depth alone
            if (sam_out is not None and not (cfg.sam & 2096)) \
                    or cfg.ID_t == 0.0:
                assem, _mx = assemble_template(
                    store.get(template), t_len,
                    frag_lists.get(template, []) if ndrv is None else [],
                    kmersize, cfg, rew,
                    points, name, None, sam_out=sam_out, force_skip=True,
                    stage=None if ndrv is None
                    else ndrv.stage_template(template))
                if cfg.ID_t == 0.0:
                    depth = assem.depth / t_len
                    aln_len = assem.aln_len
                    cover = 100.0 * aln_len / t_len
                    q_cover = math.inf if aln_len == 0 \
                        else 100.0 * t_len / aln_len
                    res_out.write(writers.res_row(
                        name, read_score, expected, t_len, 0.0, cover,
                        0.0, q_cover, depth, q_value, p_value))
                    if tsv_out is not None:
                        tsv_out.write(tsv_row(
                            cfg.tsv, name, assem, t_len,
                            int(read_counts[template]), read_score,
                            expected, q_value, p_value,
                            int(alignment_scores[template])))
                    if mapstat_out is not None:
                        mapstat_out.write(writers.mapstat_row(
                            name, assem, int(fragment_counts[template]),
                            int(read_counts[template])))
            continue

        if xml_out is not None:
            from .out.xmlout import xml_new_iter
            xml_new_iter(xml_out, template, t_len, name)
        tindex = store.get(template)
        if ndrv is not None and tindex.native is None:
            # reuse the driver's step-3 template index for assembly
            tindex.native = ndrv.template_handle(template)
        if ndrv is not None and not cfg.sasm:
            # fused native assembly: stage + frag loop + .frag.gz rows in
            # one call against the driver's frag lists
            assem = Assem()
            matrix = AssemblyMatrix(t_len)
            a_score, a_fa, a_ra, rows = ndrv.assemble_template(
                template, cfg, rew.Wl, matrix, t_len, name.encode(),
                dev_pileup=_dev_pileup)
            assem.score = a_score
            assem.fragmentCountAln = a_fa
            assem.readCountAln = a_ra
            if frag_out is not None and rows:
                frag_out.write(rows)
            if assem.score:
                call_consensus(matrix, assem, tindex.codes, t_len,
                               cfg.bcd, cfg.evalue, cfg.support_static,
                               cfg.base_caller, cfg.significant)
                if not cfg.dense:
                    trim_dual_gaps(assem)
            else:
                assem.t = np.empty(0, np.uint8)
                assem.s = np.empty(0, np.uint8)
                assem.q = np.empty(0, np.uint8)
                assem.len = 0
        else:
            assem, matrix = assemble_template(
                tindex, t_len,
                frag_lists.get(template, []) if ndrv is None else [],
                kmersize, cfg, rew,
                points, name, frag_out, sam_out=sam_out,
                xml_writer=xml_writer, xml_template=template,
                stage=None if ndrv is None
                else ndrv.stage_template(template),
                dev_pileup=_dev_pileup)
        if cfg.ef and assem.score:
            get_extended_features(assem, matrix, tindex.codes, t_len)
        if assem.cover > 0:
            cover_score = assem.cover
            depth = assem.depth / t_len
            id_ = 100.0 * cover_score / t_len
            aln_len = assem.aln_len
            q_id = 100.0 * cover_score / aln_len
            cover = 100.0 * aln_len / t_len
            q_cover = 100.0 * t_len / aln_len
        elif cfg.mem_mode:
            # runkma.c:1515-1523: MEM keeps depth/cover of empty assemblies
            id_ = 0.0
            q_id = 0.0
            depth = assem.depth / t_len
            aln_len = assem.aln_len
            cover = 100.0 * aln_len / t_len
            q_cover = 0.0
        else:
            aln_len = 0
            id_ = 0.0
            depth = q_id = cover = q_cover = 0.0

        if xml_out is not None:
            from .out.xmlout import xml_cap_iter
            xml_cap_iter(xml_out, db_size, seqin_size, t_len,
                         int(read_counts[template]), p_value, read_score,
                         assem.q, aln_len)
        printed_gate = (cfg.ID_t <= id_ and cfg.Depth_t <= depth) \
            if cfg.mem_mode else \
            (cfg.ID_t <= id_ and 0 < id_ and cfg.Depth_t <= depth)
        if printed_gate:
            res_out.write(writers.res_row(name, read_score, expected, t_len,
                                          id_, cover, q_id, q_cover, depth,
                                          q_value, p_value))
            if tsv_out is not None:
                tsv_out.write(tsv_row(cfg.tsv, name, assem, t_len,
                                      int(read_counts[template]),
                                      read_score, expected, q_value,
                                      p_value,
                                      int(alignment_scores[template])))
            if fsa_out is not None:
                writers.print_consensus(assem, name, aln_out, fsa_out,
                                        cfg.ref_fsa)
            if matrix_out is not None:
                matrix_out.write(writers.matrix_rows(
                    matrix, tindex.codes, name, t_len))
            if mapstat_out is not None:
                mapstat_out.write(writers.mapstat_row(
                    name, assem, int(fragment_counts[template]),
                    int(read_counts[template])))
            if vcf_out is not None:
                from .assemble.pileup import make_base_caller
                from .out.vcf import vcf_rows
                bc = make_base_caller(cfg.base_caller, cfg.significant,
                                      cfg.evalue, cfg.support_static)
                vcf_out.write(vcf_rows(
                    name, assem.t, cfg.evalue, cfg.support, cfg.bcd,
                    t_len, matrix, cfg.vcf,
                    lambda bn, tn, bs, du, row: bc(bn, tn, bs, du, row)))

    res_out.close()
    if xml_out is not None:
        from .out.xmlout import xml_cap
        xml_cap(xml_out)
        if xml_out is not sys.stdout:
            xml_out.close()
    for f in (fsa_out, aln_out, frag_out, matrix_out, mapstat_out, vcf_out,
              tsv_out):
        if f is not None:
            f.close()
    _stage("# Total time used for local assembly: %.2f s.\n#"
           % (time.process_time() - _t_asm))
    _stage("# Closing files")
    return status


class _SpltRec:
    """One spltDB anker-stream record (print_ankers_spltDB,
    spltdb.c:54-194): read number, rc_flag, template list, flag, seq."""

    __slots__ = ("num", "rc_flag", "tl", "flag", "codes", "header")

    def __init__(self, num, rc_flag, tl, flag, codes, header):
        self.num = num
        self.rc_flag = int(rc_flag)
        self.tl = tl
        self.flag = int(flag)
        self.codes = codes
        self.header = header


_UINT_MAX = 0xFFFFFFFF


def run_kma_spltdb(db_prefixes: List[str], output_prefix: str,
                   input_files: List[str], cfg: MapConfig,
                   exe_cmd: str = "kma_tpu",
                   pe_files: Optional[List[str]] = None,
                   int_files: Optional[List[str]] = None,
                   mh: Optional[tuple] = None) -> int:
    """Multiple -t_db: the spltDB map/reduce flow.

    The reference runs one ``-s2`` mapper per shard DB (kma.c:1330-1424)
    whose anker streams are merged by runKMA_spltDB (spltdb.c:401-1293).
    Here each read is scanned against every shard index and the reducer's
    exact merge rule is applied to the per-shard record streams: the
    shard(s) with the highest ``abs(rc_flag)`` win, ties contribute the
    union of their template lists offset by the shard's dbBias, and
    inferior records from shards > 0 are consumed silently.  Stream 0 is
    excluded from the inferior-record wipe (spltdb.c:722-731 never
    reaches i == 0), so a read whose shard-0 score is strictly inferior
    is scored a second time with shard 0's list alone -- observable
    reference behaviour that is reproduced here.

    ``mh`` = (coordinator, num_processes, process_id) distributes the
    DB axis over a ``jax.distributed`` process group (the reference's
    one-mapper-per-shard layout, lifted to hosts): each process scans
    the full read stream against its round-robin subset of shards, the
    per-shard anker streams are all-gathered, and rank 0 runs the
    reducer.  Outputs are bit-identical for any process count.
    """
    from .index.format import load_comp_b, load_length_b, load_names

    _pid, _np = 0, 1
    if mh is not None:
        import jax
        coord, nproc, pid = mh
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=int(nproc),
                                   process_id=int(pid))
        _pid, _np = int(pid), int(nproc)

    # the reducer always scores ankers MEM-style and gates output like
    # runKMA_MEM (spltdb.c:697-699,1182-1196)
    cfg.mem_mode = True

    # --- load shard DBs (spltdb.c:440-480) -------------------------------
    idxs = []
    biases: List[int] = [0]
    lengths_parts: List[np.ndarray] = []
    for p in db_prefixes:
        if cfg.deCon:
            idx = load_comp_b(p + ".decon.comp.b")
            idx.template_lengths = load_length_b(p + ".length.b")
            idx.names = load_names(p + ".name")
            idx.seq_path = p + ".seq.b"
        else:
            idx = load_index(p)
        idxs.append(idx)
        lengths_parts.append(idx.template_lengths.astype(np.int64))
        biases.append(biases[-1] + int(idx.db_size))
    n_shards = len(idxs)
    db_size = biases[-1]
    template_lengths = np.concatenate(lengths_parts)
    kmersize = cfg.kmersize or int(lengths_parts[0][0])
    if kmersize < 4 or 32 < kmersize:
        # spltdb.c:478 allows 32 (runKMA clamps at 31)
        kmersize = 16
    name_of_map: Dict[int, bytes] = {}
    for n, idx in enumerate(idxs):
        for j, nm in enumerate(idx.names):
            name_of_map[biases[n] + 1 + j] = nm

    pen = cfg.penalties
    dmat = pen.score_matrix()
    rew = Penalty(M=pen.M, MM=pen.MM, U=pen.U, W1=pen.W1, Wl=pen.Wl,
                  d=dmat, PE=pen.PE)
    set_preseed_exhaustive(1 if cfg.exhaustive else 0)
    from .mapping.scan import Proxi
    scan_proxi = Proxi(cfg.min_frac) if 0 <= cfg.min_frac < 1.0 else None
    scanners = [SaveKmersScanner(idx, pen, exhaustive=cfg.exhaustive,
                                 proxi=scan_proxi)
                for idx in idxs]
    points = Points()

    alignment_scores = np.zeros(db_size, dtype=np.int64)
    uniq_alignment_scores = np.zeros(db_size, dtype=np.int64)

    # --- phase A: per-shard anker streams --------------------------------
    # Each shard mapper is a one2one save_kmers scan (kma.c:1259-1276
    # forces kmerScan = save_kmers / save_kmers_count and one2one = 1).
    streams: List[List[_SpltRec]] = [[] for _ in range(n_shards)]
    # db-axis ownership: process p scans shards p, p+N, ... (one mapper
    # per shard in the reference; round-robin over processes here)
    my_shards = [n for n in range(n_shards) if n % _np == _pid]
    readnum = 0

    def decon_filter(n: int, tl: List[int]) -> List[int]:
        """deConPrint per shard; contamination id is the shard's DB_size
        (kma.c:1489-1493, ankers.c:106-124)."""
        cont = int(idxs[n].db_size)
        lst = [int(t) for t in tl]
        for i in range(len(lst) - 1, -1, -1):
            if lst[i] == cont:
                lst[i] = lst[-1]
                lst.pop()
                break
        for i in range(len(lst) - 1, -1, -1):
            if lst[i] == -cont:
                lst[i] = lst[-1]
                lst.pop()
                break
            if lst[i] > 0:
                break
        return lst

    def push(n: int, rc_flag, tl, flag, codes, header,
             filtered: bool = False):
        tl = [int(t) for t in tl]
        if cfg.deCon and not filtered:
            tl = decon_filter(n, tl)
            if not tl:
                return
        streams[n].append(_SpltRec(readnum, rc_flag, tl, flag, codes,
                                   header))

    use_count = cfg.ck
    if use_count:
        from .mapping.scan import save_kmers_count

    def scan_se(n: int, read) -> None:
        sc = scanners[n]
        if use_count:
            hit = save_kmers_count(idxs[n], pen, read.codes,
                                   read.n_positions, read.header,
                                   cfg.exhaustive, sc.Score, sc.Score_r)
        else:
            hit = sc.scan(read.codes, read.n_positions, read.header)
        if hit is not None:
            push(n, hit.rc_flag, hit.templates, hit.flag, hit.codes,
                 hit.header)

    qc = None
    if cfg.qc_report:
        from .utils.qc import QCStat
        qc = QCStat(cfg.qc_report - 1)

    if input_files and input_files != ["--"] or not (pe_files or int_files):
        for read in iter_reads(input_files, min_phred=cfg.min_phred,
                               hardmask_q=cfg.hardmask_q, min_q=cfg.min_q,
                               min_len=cfg.min_len, max_len=cfg.max_len,
                               qc=qc):
            readnum += 1
            for n in my_shards:
                scan_se(n, read)

    def _pair_stream():
        from .io.pipeline import iter_read_pairs
        if pe_files:
            yield from iter_read_pairs(pe_files, min_phred=cfg.min_phred,
                                       hardmask_q=cfg.hardmask_q,
                                       min_q=cfg.min_q,
                                       min_len=cfg.min_len,
                                       max_len=cfg.max_len, qc=qc)
        if int_files:
            yield from iter_read_pairs(int_files, min_phred=cfg.min_phred,
                                       hardmask_q=cfg.hardmask_q,
                                       min_q=cfg.min_q,
                                       min_len=cfg.min_len,
                                       max_len=cfg.max_len, qc=qc,
                                       interleaved=True)

    if pe_files or int_files:
        from .mapping.pair import (save_kmers_force_pair,
                                   save_kmers_penalty_pair,
                                   save_kmers_union_pair)
        scan_pair = {"u": save_kmers_union_pair,
                     "p": save_kmers_penalty_pair,
                     "f": save_kmers_force_pair}[cfg.pair_mode]
        pair_inner = None
        if cfg.ck:
            from .mapping.pair import get_kmers_for_pair_count
            pair_inner = get_kmers_for_pair_count
        for r1, r2 in _pair_stream():
            readnum += 1
            if r2 is None:
                for n in my_shards:
                    hit = scanners[n].scan(r1.codes, r1.n_positions,
                                           r1.header)
                    if hit is not None:
                        push(n, hit.rc_flag, hit.templates, hit.flag,
                             hit.codes, hit.header)
                continue
            if len(r1.codes) < kmersize or len(r2.codes) < kmersize:
                for n in my_shards:
                    for r in (r1, r2):
                        if len(r.codes) >= kmersize:
                            hit = scanners[n].scan(r.codes, r.n_positions,
                                                   r.header)
                            if hit is not None:
                                push(n, hit.rc_flag, hit.templates,
                                     hit.flag, hit.codes, hit.header)
                continue
            for n in my_shards:
                sc = scanners[n]
                pa = scan_pair(idxs[n], pen, r1.codes, r2.codes, r1.header,
                               r2.header, cfg.exhaustive, sc.Score,
                               sc.Score_r, sc.extendScore, sc.include,
                               pair_fn=pair_inner)
                if pa is None or not pa.records:
                    continue
                if len(pa.records) == 2 and len(pa.records[0][3]) == 0:
                    # proper pair: printPair (ankers.c:150-161) -- first
                    # record carries qseq with 0 templates, second carries
                    # qseq_r with the shared list
                    c_a, _np_a, sc_a, _t0, h_a, f_a = pa.records[0]
                    c_b, _np_b, sc_b, tl, h_b, f_b = pa.records[1]
                    tl = [int(t) for t in tl]
                    if cfg.deCon:
                        tl = decon_filter(n, tl)
                        if not tl:
                            continue
                    push(n, sc_a, [], f_a, c_a, h_a, filtered=True)
                    push(n, sc_b, tl, f_b, c_b, h_b, filtered=True)
                else:
                    for (c, _npos, s, tl2, h, f) in pa.records:
                        push(n, s, tl2, f, c, h)

    if qc is not None and _pid == 0:
        from .utils.qc import print_qcstat
        with open(output_prefix + ".json", "w") as jf:
            print_qcstat(qc, cfg.min_q, max(cfg.min_phred, cfg.hardmask_q),
                         cfg.hardmask_q, cfg.min_len, cfg.max_len,
                         cfg.five_clip, cfg.three_clip, jf)

    if mh is not None and _np > 1:
        # gather every process's owned shard streams; rank 0 reduces
        import pickle
        from .parallel.multihost import _allgather_blob
        blob = pickle.dumps({n: streams[n] for n in my_shards},
                            protocol=pickle.HIGHEST_PROTOCOL)
        blobs = _allgather_blob(blob)
        print("# multihost spltDB: %d processes, %d shards"
              % (_np, n_shards), file=sys.stderr)
        if _pid != 0:
            return 0
        for b in blobs:
            for n, recs in pickle.loads(b).items():
                streams[n] = recs

    # --- phase B: the reducer merge (spltdb.c:638-803) -------------------
    records: List[FragRecord] = []
    pos = [0] * n_shards

    def num_at(i: int) -> int:
        return streams[i][pos[i]].num if pos[i] < len(streams[i]) \
            else _UINT_MAX

    def cur(i: int) -> _SpltRec:
        return streams[i][pos[i]]

    def consume(i: int) -> _SpltRec:
        rec = streams[i][pos[i]]
        pos[i] += 1
        return rec

    def emit(qa, best_hits, score, merged, ends, ha, fa, mate=None):
        """update_Scores_MEM / _pe_MEM (updatescores.c:26-107)."""
        nt = len(merged)
        if nt == 1:
            t0 = abs(merged[0])
            alignment_scores[t0] += score
            uniq_alignment_scores[t0] += score
        else:
            for t in merged:
                alignment_scores[abs(t)] += score
        rec = FragRecord(q_len=len(qa), best_hits=best_hits,
                         score=-score if mate is not None else score,
                         header=ha, flag=fa, codes=qa,
                         starts=[0] * nt, ends=ends, templates=merged)
        if mate is not None:
            rec.mate_codes, rec.mate_header, rec.mate_flag = mate
        records.append(rec)

    target = 0
    target_score = 0
    rc_flag = 0
    best_targets: List[int] = []
    while target != _UINT_MAX:
        # join best templates (spltdb.c:645-671)
        read_score = 0
        merged: List[int] = []
        qa = ha = None
        fa = fr = 0
        qr = hr = None
        qa_len = 0
        qr_len = 0
        for sh in best_targets:
            rec = consume(sh)
            qa, ha, fa = rec.codes, rec.header, rec.flag
            qa_len = len(rec.codes)
            if rec.tl:
                read_score = 0
                seg = rec.tl
            else:
                rec2 = consume(sh)
                qr, hr, fr = rec2.codes, rec2.header, rec2.flag
                qr_len = len(rec2.codes)
                seg = rec2.tl
                read_score = 1
            bias = biases[sh]
            merged.extend(t + bias for t in seg)

        if best_targets and kmersize <= qa_len:
            best_read_score = target_score
            ends = [int(template_lengths[abs(t)]) for t in merged]
            nt = len(merged)
            best_hits = nt
            if rc_flag < 0 and merged and merged[-1] > 0:
                best_hits = -nt
            if read_score and kmersize <= qr_len:
                # PE total is targetScore + 1, not the sum of both mates'
                # scores (spltdb.c:661,695-697)
                emit(qa, best_hits, best_read_score + read_score, merged,
                     ends, fa=fa, ha=ha, mate=(qr, hr, fr))
            else:
                emit(qa, best_hits, best_read_score, merged, ends, fa=fa,
                     ha=ha)

        # remove inferior read matches (spltdb.c:718-752); stream 0 is
        # never wiped -- the `while(i)` walk stops at i == 1
        if merged:
            if read_score or (fa & 1) == 0 or (fa & 128):
                for i in range(n_shards - 1, 0, -1):
                    while num_at(i) == target:
                        consume(i)
            elif fa & 64:
                for i in range(n_shards - 1, 0, -1):
                    if num_at(i) == target:
                        h = cur(i)
                        if (h.flag & 128) and not h.tl:
                            pass  # conserve second non-paired
                        else:
                            consume(i)

        # get best templates for next read (spltdb.c:754-796)
        target = _UINT_MAX
        target_score = _UINT_MAX
        rc_flag = 0
        best_targets = []
        for i in range(n_shards):
            ni = num_at(i)
            if ni < target:
                target = ni
                rc_flag = cur(i).rc_flag
                target_score = abs(rc_flag)
                best_targets = [i]
            elif ni == target and ni != _UINT_MAX:
                a3 = abs(cur(i).rc_flag)
                if target_score < a3:
                    rc_flag = cur(i).rc_flag
                    target_score = a3
                    best_targets = [i]
                elif target_score == a3:
                    best_targets.append(i)
                    if rc_flag >= 0:
                        rc_flag = cur(i).rc_flag
                else:
                    # inferior: consume (twice when it is a PE start)
                    if not cur(i).tl:
                        consume(i)
                    consume(i)

    # --- phase C: ConClave + assembly over the concatenated DB -----------
    store = MultiTemplateStore(db_prefixes, lengths_parts, biases, kmersize)
    seqin_sizes = [4 * os.path.getsize(p + ".seq.b") for p in db_prefixes]
    splt = {
        "db_names": list(db_prefixes),
        "fragment_count": readnum - 1,  # trailing out_Tem[2]-1 (kmers.c:254)
        "boundary": frozenset(biases[1:-1]),
        "biases": biases,
        "seqin_sizes": seqin_sizes,
    }

    def sam_init(out):
        # saminit per shard, no CL (spltdb.c:466-471)
        from .out.sam import sam_header
        for idx in idxs:
            sam_header(idx.names, idx.template_lengths, None, out)

    def name_of(template: int) -> str:
        return name_of_map[template].decode("latin1")

    return _conclave_and_output(
        records, db_size, template_lengths, name_of, store,
        alignment_scores, uniq_alignment_scores, cfg, rew, points, kmersize,
        db_prefixes[0], output_prefix, exe_cmd, readnum,
        sam_init=sam_init, splt=splt)


def run_kma_mt1(db_prefix: str, output_prefix: str, input_files: List[str],
                cfg: MapConfig, mt1: int, exe_cmd: str = "kma_tpu",
                pe_files: Optional[List[str]] = None) -> int:
    """-Mt1 <n>: map every read against template n only (mt1.c:86-500).

    Step 1 spools trimmed reads directly as assembly fragment records
    (printFsaMt1/printFsa_pairMt1, mt1.c:46-84; template 0, best_hits 1,
    score 0, flags 0/97/145 with the second mate reverse-complemented);
    step 3 is one assemble_KMA over the single template."""
    from .index.format import load_length_b, load_names, load_template_seq

    lengths = load_length_b(db_prefix + ".length.b")
    kmersize = cfg.kmersize
    if kmersize < 4:
        kmersize = int(lengths[0])
        if 32 < kmersize or kmersize < 4:
            kmersize = 16
    t_len = int(lengths[mt1])
    names = load_names(db_prefix + ".name")
    name = names[mt1 - 1].decode("latin1")

    pen = cfg.penalties
    rew = Penalty(M=pen.M, MM=pen.MM, U=pen.U, W1=pen.W1, Wl=pen.Wl,
                  d=pen.score_matrix())
    points = Points()
    words = load_template_seq(db_prefix + ".seq.b", lengths.astype(np.int64),
                              mt1)
    tindex = TemplateIndex(unpack_2bit(words, t_len), kmersize)

    # step 1: reads become Frag records directly; printFsaMt1's static
    # flag buffer leaks the last pair flag into later singles
    frags: List[Frag] = []
    flag_state = [0]

    def add(codes, header, flag=None):
        if flag is not None:
            flag_state[0] = flag
        frags.append(Frag(q_len=len(codes), best_hits=1, score=0, start=0,
                          end=0, header=header, flag=flag_state[0],
                          codes=codes))

    qc = None
    if cfg.qc_report:
        from .utils.qc import QCStat
        qc = QCStat(cfg.qc_report - 1)
    if input_files and input_files != ["--"] or not pe_files:
        for read in iter_reads(input_files, min_phred=cfg.min_phred,
                               hardmask_q=cfg.hardmask_q, min_q=cfg.min_q,
                               min_len=cfg.min_len, max_len=cfg.max_len,
                               qc=qc):
            add(read.codes, read.header)
    if pe_files:
        from .io.pipeline import iter_read_pairs
        for r1, r2 in iter_read_pairs(pe_files, min_phred=cfg.min_phred,
                                      hardmask_q=cfg.hardmask_q,
                                      min_q=cfg.min_q, min_len=cfg.min_len,
                                      max_len=cfg.max_len, qc=qc):
            if r2 is None:
                add(r1.codes, r1.header)
            else:
                add(r1.codes, r1.header, flag=97)
                add(rc_codes(r2.codes), r2.header, flag=145)

    if qc is not None:
        from .utils.qc import print_qcstat
        with open(output_prefix + ".json", "w") as jf:
            print_qcstat(qc, cfg.min_q, max(cfg.min_phred, cfg.hardmask_q),
                         cfg.hardmask_q, cfg.min_len, cfg.max_len,
                         cfg.five_clip, cfg.three_clip, jf)

    # outputs (mt1.c:121-186)
    res_out = open(output_prefix + ".res", "w")
    res_out.write(writers.RES_HEADER)
    tsv_out = None
    if cfg.tsv:
        tsv_out = open(output_prefix + ".tsv", "w")
        tsv_out.write(tsv_headerline(cfg.tsv))
    frag_out = None if cfg.nf else writers.open_gz(output_prefix + ".frag.gz")
    fsa_out = aln_out = None
    if (cfg.nc & 1) == 0:
        fsa_out = open(output_prefix + ".fsa", "w")
    if (cfg.nc & 2) == 0:
        aln_out = open(output_prefix + ".aln", "w")
        if fsa_out is None:
            fsa_out = open(output_prefix + ".fsa", "w")
    matrix_out = (writers.open_gz(output_prefix + ".mat.gz")
                  if cfg.print_matrix else None)
    vcf_out = None
    if cfg.vcf:
        from .out.vcf import vcf_header
        vcf_out = writers.open_gz(output_prefix + ".vcf.gz")
        vcf_out.write(vcf_header(db_prefix))
    sam_out = sys.stdout if cfg.sam else None
    if sam_out is not None:
        sam_out.write("@PG\tID:KMA\tPN:kma\tVN:%s\tCL:%s\n"
                      % ("1.5.1", exe_cmd))
        sam_out.write("@SQ\tSN:%s\tLN:%d\n" % (name, t_len))
    xml_out = None
    xml_writer = None
    if cfg.xml:
        from .out.xmlout import (XmlHitWriter, xml_init, xml_new_iter)
        xml_out = sys.stdout if cfg.xml == 2 \
            else open(output_prefix + ".xml", "w")
        # mt1.c:174-177: totFrags 1, argv = the previous-step command
        xml_init(xml_out, db_prefix, 1, exe_cmd, int(time.time()))
        xml_writer = XmlHitWriter(xml_out, rew)
        xml_new_iter(xml_out, mt1, t_len, name)

    # hitXML receives thread->template which Mt1 sets to 0 (mt1.c:381)
    assem, matrix = assemble_template(tindex, t_len, frags, kmersize, cfg,
                                      rew, points, name, frag_out,
                                      sam_out=sam_out, xml_writer=xml_writer,
                                      xml_template=0)
    read_score = int(assem.score)
    p_value = p_chisqr(read_score)
    cmp = CMP[cfg.cmp_mode]
    depth = 0.0
    aln_len_xml = 0
    consensus_printed = False
    if cmp(p_value <= cfg.evalue and read_score > 0,
           read_score >= cfg.score_t * t_len):
        if assem.cover > 0:
            cover_score = assem.cover
            depth = float(assem.depth) / t_len
            id_ = 100.0 * cover_score / t_len
            aln_len = assem.aln_len
            aln_len_xml = aln_len
            q_id = 100.0 * cover_score / aln_len
            cover = 100.0 * aln_len / t_len
            q_cover = 100.0 * t_len / aln_len
        else:
            id_ = cover = q_id = q_cover = 0.0
        if cfg.ID_t <= id_ and 0 < id_ and cfg.Depth_t <= depth:
            res_out.write(
                "%s\t%8d\t%8d\t%8d\t%8.2f\t%8.2f\t%8.2f\t%8.2f\t%8.2f\t"
                "%8.2f\t%4.1e\n" % (name, read_score, 0, t_len, id_, cover,
                                    q_id, q_cover, depth,
                                    float(read_score), p_value))
            consensus_printed = fsa_out is not None
            if tsv_out is not None:
                tsv_out.write(tsv_row(cfg.tsv, name, assem, t_len,
                                      assem.readCountAln, read_score, 0,
                                      float(read_score), p_value,
                                      read_score))
            if fsa_out is not None:
                writers.print_consensus(assem, name, aln_out, fsa_out,
                                        cfg.ref_fsa)
            if matrix_out is not None:
                matrix_out.write(writers.matrix_rows(
                    matrix, tindex.codes, name, t_len))
            if vcf_out is not None:
                from .assemble.pileup import make_base_caller
                from .out.vcf import vcf_rows
                bc = make_base_caller(cfg.base_caller, cfg.significant,
                                      cfg.evalue, cfg.support_static)
                vcf_out.write(vcf_rows(
                    name, assem.t, cfg.evalue, cfg.support, cfg.bcd, t_len,
                    matrix, cfg.vcf,
                    lambda bn, tn, bs, du, row: bc(bn, tn, bs, du, row)))
    elif cfg.ID_t == 0.0:
        res_out.write(
            "%s\t%8d\t%8d\t%8d\t%8.2f\t%8.2f\t%8.2f\t%8.2f\t%8.2f\t%8.2f\t"
            "%4.1e\n" % (name, read_score, 0, t_len, 0.0, 0.0, 0.0, 0.0,
                         depth, float(read_score), p_value))
        if tsv_out is not None:
            tsv_out.write(tsv_row(cfg.tsv, name, assem, t_len,
                                  assem.readCountAln, read_score, 0,
                                  float(read_score), p_value, read_score))

    if xml_out is not None:
        from .out.xmlout import xml_cap, xml_cap_iter
        # mt1.c:462 runs AFTER printConsensus, which compacts q in place
        # (gap removal + NUL, printconsensus.c:39-54); the entropy window
        # sees the compacted prefix, the NUL, then stale tail bytes
        q_xml = np.array(assem.q, copy=True) if assem.q is not None \
            else np.empty(0, np.uint8)
        if consensus_printed and len(q_xml):
            if cfg.ref_fsa == 0:
                kept = q_xml[q_xml != ord("-")]
                mut = q_xml.copy()
                mut[: len(kept)] = kept
                if len(kept) < len(mut):
                    mut[len(kept)] = 0
                q_xml = mut
            elif cfg.ref_fsa == 1:
                q_xml = np.where(q_xml == ord("-"),
                                 np.uint8(ord("n")), q_xml)
        # mt1.c:462-465: db-num 1, db-len t_len, hsp-len = read_score
        xml_cap_iter(xml_out, 1, t_len, t_len, read_score, p_value,
                     read_score, q_xml, aln_len_xml)
        xml_cap(xml_out)
        if xml_out is not sys.stdout:
            xml_out.close()
    res_out.close()
    for f in (fsa_out, aln_out, frag_out, matrix_out, vcf_out, tsv_out):
        if f is not None:
            f.close()
    return 0




def _pileup_floor(cfg: MapConfig) -> int:
    """Aligned bytes a template needs before its pileup goes to the
    device: every template under ``-device on``; under ``-device auto``
    only deep ones (KMA_TPU_PILEUP_MIN_KB, default 256), which amortize
    a daemon round trip."""
    if cfg.device == "on":
        return 0
    return int(os.environ.get("KMA_TPU_PILEUP_MIN_KB", "256")) << 10


def _apply_dev_pileup(dev_pileup, bufs, matrix, t_len):
    """Ship the armed export's rows to the device pileup and merge the
    delta (saturating at USHRT_MAX like the host scatter)."""
    from .align import native_aln as _nat
    n_rows, used, _over = _nat.take_pileup_export()
    if not n_rows:
        return
    p_t, p_q, p_off, p_start = bufs
    delta = dev_pileup(p_t[:used], p_q[:used], p_off[: n_rows + 1],
                       p_start[:n_rows], t_len)
    np.minimum(matrix.counts[:t_len] + delta, 0xFFFF,
               out=matrix.counts[:t_len])


def assemble_template(tindex: TemplateIndex, t_len: int, frags: List[Frag],
                      kmersize: int, cfg: MapConfig, rew: Penalty,
                      points: Points, name: str, frag_out, sam_out=None,
                      xml_writer=None, xml_template: int = 0,
                      force_skip: bool = False, stage=None,
                      dev_pileup=None):
    """assemble_KMA for one template (assembly.c:1689-2127).

    ``stage`` carries the fused driver's pre-staged frag arrays
    (run_native.RunDriver.stage_template) instead of Frag objects."""
    from .out.writers import frag_row

    assem = Assem()
    matrix = AssemblyMatrix(t_len)
    Wl = rew.Wl

    if cfg.sasm or force_skip:
        # skip_assemble_KMA (assembly.c:1209-1315): no alignment; depth
        # sums read lengths, SAM records are emitted unmapped-flagged
        assem.len = t_len
        if stage is not None:
            assem.depth += int(stage[0].sum())
        for frag in frags:
            assem.depth += frag.q_len
            if sam_out is not None:
                from .out.sam import sam_record
                stats2 = [frag.best_hits, frag.flag | 4]
                sam_record(frag.codes, frag.header, name, None, stats2,
                           sam_out)
        assem.cover = 0
        assem.aln_len = 0
        assem.t = np.empty(0, np.uint8)
        assem.s = np.empty(0, np.uint8)
        assem.q = np.empty(0, np.uint8)
        return assem, matrix

    if stage is not None:
        # fused-driver staged arrays: one native assembly call, frag_row
        # writes from the flat buffers (no per-frag Python objects)
        from .align import native_aln as _nat
        (s_qlen, s_bh, s_score, s_qb, s_fs, s_flag, s_codes, s_coff,
         s_hdr, s_hoff) = stage
        n = len(s_qlen)
        matrix.ensure(matrix.len + len(s_codes) + 1)
        _pb = None
        if dev_pileup is not None and cfg.dense \
                and len(s_codes) >= _pileup_floor(cfg):
            _pb = _nat.arm_pileup_export(
                n, 2 * len(s_codes) + t_len + 4096)
        new_len, acc, rcu, rs, ms, stt, enn, lnn = \
            _nat.assembly_frags_batch(
                tindex, s_codes, s_coff, s_qb, s_fs, n, rew, rew.Wl,
                cfg.min_len, cfg.mq, cfg.score_t, cfg.mrc, cfg.circular,
                cfg.ts, cfg.skip_tail_aln, cfg.dense, matrix.counts,
                matrix.next, matrix.len, t_len)
        matrix.len = int(new_len)
        if _pb is not None:
            _apply_dev_pileup(dev_pileup, _pb, matrix, t_len)
        for i in range(n):
            if acc[i] != 1:
                continue
            assem.score += int(ms[i])
            fl = int(s_flag[i])
            if not (fl & 2) or (fl & 64):
                assem.fragmentCountAln += 1
            assem.readCountAln += 1
            if frag_out is not None:
                ci = s_codes[s_coff[i]:s_coff[i + 1]]
                fc = rc_codes(ci) if rcu[i] else ci
                stats = [int(s_bh[i]), int(rs[i]), int(stt[i]),
                         int(enn[i]), fl]
                frag_out.write(frag_row(
                    fc, stats, name,
                    s_hdr[s_hoff[i]:s_hoff[i + 1]].tobytes()))
        if assem.score:
            call_consensus(matrix, assem, tindex.codes, t_len, cfg.bcd,
                           cfg.evalue, cfg.support_static,
                           cfg.base_caller, cfg.significant)
            if not cfg.dense:
                trim_dual_gaps(assem)
        else:
            assem.t = np.empty(0, np.uint8)
            assem.s = np.empty(0, np.uint8)
            assem.q = np.empty(0, np.uint8)
            assem.len = 0
        return assem, matrix

    # batched frag loop (no sam/xml writers): realignments + alnToMat run
    # in one native call per template
    from .align import native_aln as _nat
    use_batch_asm = (sam_out is None and xml_writer is None and frags
                     and _nat.get_lib() is not None)
    if use_batch_asm:
        import struct as _st
        n = len(frags)
        codes_l = [np.ascontiguousarray(f.codes, np.uint8) for f in frags]
        codes_off = np.zeros(n + 1, np.int64)
        for i, c in enumerate(codes_l):
            codes_off[i + 1] = codes_off[i] + len(c)
        codes_flat = np.concatenate(codes_l)
        qb = np.zeros(2 * n, np.int32)
        fs = np.zeros(3 * n, np.int32)
        total_q = 0
        for i, f in enumerate(frags):
            q_len = f.q_len
            q_start, q_end = 0, q_len
            h = f.header
            if len(h) > 2 * 4 + 1 and h[len(h) - 2 * 4 - 1] == 0:
                q_start, q_end = _st.unpack_from("<ii", h, len(h) - 8)
            qb[2 * i] = q_start
            qb[2 * i + 1] = q_end
            fs[3 * i] = f.score
            fs[3 * i + 1] = f.start
            fs[3 * i + 2] = f.end
            total_q += q_len
        matrix.ensure(matrix.len + total_q + 1)
        _pb = None
        if dev_pileup is not None and cfg.dense \
                and total_q >= _pileup_floor(cfg):
            _pb = _nat.arm_pileup_export(
                n, 2 * total_q + t_len + 4096)
        new_len, acc, rcu, rs, ms, stt, enn, lnn = \
            _nat.assembly_frags_batch(
                tindex, codes_flat, codes_off, qb, fs, n, rew, rew.Wl,
                cfg.min_len, cfg.mq, cfg.score_t, cfg.mrc, cfg.circular,
                cfg.ts, cfg.skip_tail_aln, cfg.dense, matrix.counts,
                matrix.next, matrix.len, t_len)
        matrix.len = int(new_len)
        if _pb is not None:
            _apply_dev_pileup(dev_pileup, _pb, matrix, t_len)
        for i, frag in enumerate(frags):
            if acc[i] != 1:
                continue
            assem.score += int(ms[i])
            if not (frag.flag & 2) or (frag.flag & 64):
                assem.fragmentCountAln += 1
            assem.readCountAln += 1
            if frag_out is not None:
                fc = rc_codes(frag.codes) if rcu[i] else frag.codes
                stats = [frag.best_hits, int(rs[i]), int(stt[i]),
                         int(enn[i]), frag.flag]
                frag_out.write(frag_row(fc, stats, name, frag.header))

    for frag in (() if use_batch_asm else frags):
        codes = frag.codes
        q_len = frag.q_len
        header = frag.header
        # q-bound (assembly.c:1916-1924)
        q_start, q_end = 0, q_len
        if len(header) > 2 * 4 + 1 and header[len(header) - 2 * 4 - 1] == 0:
            import struct
            q_start, q_end = struct.unpack_from("<ii", header,
                                                len(header) - 8)
        stats2, stats3 = frag.start, frag.end
        read_score = frag.score
        if xml_writer is not None:
            xml_writer.maybe_realloc(q_len)
        if read_score:
            points.len = 0
            proceed = True
        else:
            # anker_rc (align.c:780-991): seed both strands, keep the
            # winner's mems in points (reused by KMA) and its orientation
            rc_score, rc_codes_ = _anker_rc_bytes(tindex, codes, q_len,
                                                  q_start, q_end, points)
            proceed = rc_score != 0
            if rc_codes_ is not None:
                codes = rc_codes_
        if proceed:
            if stats3 <= stats2:
                stats2, stats3 = 0, t_len
            st, aligned, mapq = kma_align(
                tindex, codes, q_len, q_start, q_end, stats2,
                min(t_len, stats3), cfg.mq, rew, points, kmersize,
                traceback=True, circular=cfg.circular, ts=cfg.ts,
                skip_tails=cfg.skip_tail_aln)
            if xml_writer is not None:
                xml_writer.overlay(aligned)
            aln_len = st.len
            start = st.pos
            end = start + aln_len - st.tGaps
            if t_len < end:
                end -= t_len
            read_score = st.score
            # assembly.c:1946-1953 adds the RAW (negative) Wl per touched
            # template end — a penalty, unlike alnfrags.c:1077 which negates
            if start == 0:
                read_score += Wl
            if end == t_len:
                read_score += Wl
            if cfg.min_len <= aln_len and mrcheck(cfg.mrc, st, q_len, t_len):
                score = 1.0 * read_score / aln_len
            else:
                read_score = 0
                score = 0.0
            if 0 < read_score and cfg.score_t <= score:
                stats = [frag.best_hits, read_score, start,
                         end - t_len if t_len < end else end, frag.flag]
                if cfg.dense:
                    matrix.aln_to_mat_dense(assem, aligned.t, aligned.s,
                                            aligned.q, st.score, st.pos,
                                            frag.flag)
                else:
                    matrix.aln_to_mat(assem, aligned.t, aligned.s,
                                      aligned.q, st.score, st.pos,
                                      frag.flag)
                if frag_out is not None:
                    frag_out.write(frag_row(codes, stats, name, header))
                if sam_out is not None:
                    from .out.sam import sam_record
                    sam_record(codes, header, name, aligned, stats, sam_out)
                if xml_writer is not None:
                    xml_writer.hit(xml_template, header, aligned, st,
                                   stats[4])
            elif sam_out is not None and not (cfg.sam & 2096):
                from .out.sam import sam_record
                stats = [frag.best_hits, read_score, start,
                         end - t_len if t_len < end else end, frag.flag]
                if read_score:
                    sam_record(codes, header, name, aligned, stats, sam_out)
                else:
                    stats2 = [frag.best_hits, frag.flag | 4]
                    sam_record(codes, header, name, None, stats2, sam_out)

    if assem.score:
        call_consensus(matrix, assem, tindex.codes, t_len, cfg.bcd,
                       cfg.evalue, cfg.support_static, cfg.base_caller,
                       cfg.significant)
        # dual-gap trim is part of assemble_KMA itself (assembly.c:
        # 2094-2119, skipped for -dense) so xml entropy sees trimmed q
        if not cfg.dense:
            trim_dual_gaps(assem)
    else:
        assem.t = np.empty(0, np.uint8)
        assem.s = np.empty(0, np.uint8)
        assem.q = np.empty(0, np.uint8)
        assem.len = 0
    return assem, matrix


def _anker_rc_bytes(tindex, codes, q_len, q_start, q_end, points):
    """anker_rc for score-0 frags (align.c:780-991), e.g. every Mt1
    record: seed both strands, keep the winner's mems in points.  Returns
    (score, rc_codes_or_None); the caller swaps orientation when the rc
    strand won (the reference strrc's qseq in place) but keeps the
    original q-bounds (anker_rc only swaps its locals)."""
    from .align.kma_aln import anker_rc_bytes
    rc = rc_codes(codes)
    res = anker_rc_bytes(tindex, codes, rc, q_len, q_start, q_end, points,
                         0)
    if res < 0:
        return -res, rc
    return res, None


def run_step1(input_files: List[str], cfg: MapConfig,
              pe_files: Optional[List[str]] = None,
              int_files: Optional[List[str]] = None) -> int:
    """-s1 (kma.c:1439-1601): parse+trim only, emitting the step-1 wire
    (printFsa records, runinput.c:765-787) on stdout."""
    from .io.pipeline import iter_read_pairs, iter_reads, write_step1_record
    out = sys.stdout.buffer
    if input_files:
        for read in iter_reads(input_files, min_phred=cfg.min_phred,
                               hardmask_q=cfg.hardmask_q, min_q=cfg.min_q,
                               min_len=cfg.min_len, max_len=cfg.max_len,
                               boot=cfg.boot):
            write_step1_record(out, read)
    for files, inter in ((pe_files, False), (int_files, True)):
        if files:
            for r1, r2 in iter_read_pairs(files, min_phred=cfg.min_phred,
                                          hardmask_q=cfg.hardmask_q,
                                          min_q=cfg.min_q,
                                          min_len=cfg.min_len,
                                          max_len=cfg.max_len,
                                          interleaved=inter):
                if r2 is not None:
                    r1.mate_first = True
                    write_step1_record(out, r1)
                    write_step1_record(out, r2)
                else:
                    r1.mate_first = False
                    write_step1_record(out, r1)
    out.flush()
    return 0


def run_step2(db_prefix: str, cfg: MapConfig,
              input_files: Optional[List[str]] = None,
              pe_files: Optional[List[str]] = None,
              int_files: Optional[List[str]] = None) -> int:
    """-s2 (kma.c:1602-1605): the reference re-enters itself in a thread
    (kmapipe.c:38-53), so -s2 runs steps 1+2 from the ORIGINAL argv and
    emits the anker wire (+ -readNum terminator) on stdout."""
    import struct as _struct
    from .config import Penalties
    from .io.pipeline import iter_reads, write_anker
    from .mapping.scan import SaveKmersScanner

    idx = load_index(db_prefix, mmap=cfg.mmap, shm=cfg.shm)
    pen = cfg.penalties
    pen.d = pen.score_matrix()
    template_lengths = idx.template_lengths.astype(np.int64)
    scanner = SaveKmersScanner(idx, pen, exhaustive=cfg.exhaustive)
    scan_proxi = None
    if cfg.min_frac != 1.0:
        from .mapping.scan import Proxi
        scan_proxi = Proxi(min_frac=abs(cfg.min_frac),
                           soft=np.zeros(idx.db_size + 1, np.int64)
                           if cfg.min_frac < 0 else None)
    if cfg.hmm:
        from .mapping.hmm_scan import HmmCompBuf, hmm_scan_read
        hmm_buf = HmmCompBuf()

        def scan_one(read):
            return hmm_scan_read(idx, read.codes, read.header,
                                 template_lengths, cfg.min_len,
                                 scanner.Score, scanner.Score_r,
                                 scanner.include, mem_mode=cfg.mem_mode,
                                 proxi=scan_proxi,
                                 exhaustive=cfg.exhaustive,
                                 comp_buf=hmm_buf)
    elif not cfg.one2one:
        from .mapping.chain_scan import chain_scan_read
        from .mapping.native_chain import make_native_chain

        # native default-mode chainer (native/kma_chain.cpp, an exact
        # port of chain_scan.py); proxi/cmer shapes keep the Python path
        nchain = make_native_chain(idx, pen, template_lengths) \
            if scan_proxi is None else None
        if nchain is not None:
            def scan_one(read):
                return nchain.scan(
                    read.codes, read.header, cfg.exhaustive,
                    scanner.Score, scanner.extendScore, scanner.include,
                    cfg.min_len, cfg.cover_t, cfg.score_t, cfg.mrc,
                    cfg.lc)
        else:
            def scan_one(read):
                return chain_scan_read(
                    idx, pen, read.codes, read.header, cfg.exhaustive,
                    scanner.Score, scanner.extendScore, scanner.include,
                    template_lengths, cfg.min_len, cfg.cover_t,
                    cfg.score_t, cfg.mrc, cfg.lc, scan_proxi)
    else:
        def scan_one(read):
            hit = scanner.scan(read.codes, read.n_positions, read.header)
            return [hit] if hit is not None else []

    out = sys.stdout.buffer
    n = 0
    for read in iter_reads(input_files or [], min_phred=cfg.min_phred,
                           hardmask_q=cfg.hardmask_q, min_q=cfg.min_q,
                           min_len=cfg.min_len, max_len=cfg.max_len,
                           boot=cfg.boot):
        n += 1
        for hit in scan_one(read):
            write_anker(out, hit.codes, hit.n_positions, hit.rc_flag,
                        hit.templates, hit.header, hit.flag,
                        wire_words=hit.wire_words)
    out.write(_struct.pack("<i", -n))
    out.flush()
    return 0

"""Affine-gap Needleman-Wunsch with the reference's exact semantics (nw.c).

Full and banded variants, score-only or with alignment emission.  The row
recurrence is vectorised: per template row, P and the match term are
elementwise in the previous row, and the intra-row Q chain

    Q[n] = max(D[n+1] + W1, Q[n+1] + U)

decomposes exactly (for any penalties) into

    Q[n] = max(D0[n+1] + W1, Q[n+1] + max(W1, U)),  D0 = max(P, Msc)

which is a max-plus suffix scan — the same shape the device scorer (ops/nw_kernel.py) uses.  The 6-bit traceback byte E is reproduced
bit-exactly (op bits 1-5, "locked" bits 16/32; nw.c:166-211).

`k` encodes end-gap semantics (nw.c:26 callers, align.c:83-171):
  k == 0   : interior segment (both ends anchored)
  k == 1/2 : trailing tail (template end free; k==2 also query end free)
  k == -1  : leading tail (best leading template gap free)
  k == -2  : leading tail with free query start as well
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class AlnScore:
    score: int = 0
    pos: int = 0
    len: int = 0
    match: int = 0
    tGaps: int = 0
    qGaps: int = 0


@dataclasses.dataclass
class Aligned:
    """Alignment strings as code arrays (t/q: 0-5 with 5 = gap; s: ascii)."""

    t: np.ndarray = None
    s: np.ndarray = None
    q: np.ndarray = None
    start: int = 0
    end: int = 0
    pos: int = 0  # template length hint for circular empty-segment emission
    mapQ: int = 0


def _empty_case(t_len: int, q_len: int, W1: int, U: int, query: np.ndarray,
                template: np.ndarray, t_e: int, template_length: int,
                aligned: Optional[Aligned]) -> AlnScore:
    """t_len==0 or q_len==0 fast paths (nw.c:49-86)."""
    st = AlnScore()
    if t_len == q_len:
        if aligned is not None:
            aligned.t = np.empty(0, np.uint8)
            aligned.s = np.empty(0, np.uint8)
            aligned.q = np.empty(0, np.uint8)
        return st
    if t_len == 0:
        st.len = q_len
        st.tGaps = q_len
        st.score = W1 + (q_len - 1) * U
        if aligned is not None:
            aligned.t = np.full(q_len, 5, np.uint8)
            aligned.s = np.full(q_len, ord("_"), np.uint8)
            aligned.q = query[:q_len].copy()
        return st
    st.len = t_len
    st.qGaps = t_len
    st.score = W1 + (t_len - 1) * U
    if aligned is not None:
        tl = np.empty(t_len, np.uint8)
        nuc_pos = (t_e if t_e else aligned.pos) - 1
        for m in range(t_len - 1, -1, -1):
            tl[m] = template[nuc_pos]
            nuc_pos -= 1
            if nuc_pos < 0:
                nuc_pos = aligned.pos - 1
        aligned.t = tl
        aligned.s = np.full(t_len, ord("_"), np.uint8)
        aligned.q = np.full(t_len, 5, np.uint8)
    return st


def _row_step(D_prev: np.ndarray, P_prev: np.ndarray, D_boundary: int,
              match_scores: np.ndarray, W1: int, U: int, neg: int,
              banded: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One DP row over n = q_len-1..0, vectorised (nw.c:166-212).

    For the full variant (banded=False): P opens from D_prev[n], extends
    P_prev[n]; match uses D_prev[n+1].  D_prev/P_prev must have length
    q_len+1 (entry [q_len] = boundary of the previous row).
    For the banded variant: P uses D_prev[n-1]/P_prev[n-1] and match uses
    D_prev[n]; arrays are band-local (handled by the caller via shifting).
    Returns (D_row, P_row, E_row) for n=0..q_len-1; D_row[q_len] is NOT
    included (caller tracks boundaries).
    """
    if banded:
        Popen = D_prev[:-1] + W1       # D_prev[n-1]
        Pext = P_prev[:-1] + U         # P_prev[n-1]
        Msc = D_prev[1:] + match_scores  # D_prev[n]
    else:
        Popen = D_prev[:-1] + W1       # D_prev[n]
        Pext = P_prev[:-1] + U
        Msc = D_prev[1:] + match_scores  # D_prev[n+1]
    P = np.maximum(Popen, Pext)
    D0 = np.maximum(P, Msc)

    # suffix max-plus scan for Q over the final D (see module docstring):
    # Q[n] = max_{j>=n+1} (src[j] + W1 + (j-(n+1))*Up) where src[j] = D0[j]
    # for j < qn and src[qn] folds the row boundary and the Q-chain init
    # value `neg` (whose first extension costs U, not W1).
    Up = max(W1, U)
    qn = len(D0)
    b = np.empty(qn + 1, dtype=np.int64)
    b[:qn] = D0 + np.arange(qn, dtype=np.int64) * Up
    b[qn] = max(D_boundary, neg + U - W1) + qn * Up
    suf = np.maximum.accumulate(b[::-1])[::-1]
    idx = np.arange(qn, dtype=np.int64)
    Q = suf[1:] - (idx + 1) * Up + W1

    Qopen = np.empty(qn, dtype=np.int64)
    Qopen[:-1] = np.maximum(D0[1:], Q[1:]) + W1  # D_final[n+1] + W1
    Qopen[-1] = D_boundary + W1
    Qext_arr = np.empty(qn, dtype=np.int64)
    # Q_prev in the scan order (n descending) is Q[n+1]; for n = qn-1 it is
    # the init value `neg`
    Qext_arr[:-1] = Q[1:] + U
    Qext_arr[-1] = neg + U

    D = np.maximum(D0, Q)

    # E byte assembly (nw.c:166-211)
    e = np.where(Qopen < Popen, 4, 2).astype(np.int64)
    Dr = np.maximum(Qopen, Popen)
    bit16 = ~(Qopen < Qext_arr)
    upd3 = (Qopen < Qext_arr) & (Dr <= Qext_arr)
    Dr = np.where(upd3, Qext_arr, Dr)
    e = np.where(upd3, 3, e)
    bit32 = ~(Popen < Pext)
    upd5 = (Popen < Pext) & (Dr <= Pext)
    Dr = np.where(upd5, Pext, Dr)
    e = np.where(upd5, 5, e)
    bit1 = Dr <= Msc
    E = bit16 * 16 + bit32 * 32 + np.where(bit1, 1, e)
    return D.astype(np.int64), P.astype(np.int64), E.astype(np.uint8)


def nw_full(template: np.ndarray, query: np.ndarray, k: int, t_s: int,
            t_e: int, q_s: int, q_e: int, d: np.ndarray, W1: int, U: int,
            MM: int, template_length: int,
            aligned: Optional[Aligned] = None) -> AlnScore:
    """NW / NW_score (nw.c:26-308 / 642-890).

    `template` is the full template code array (uint8); circular segments
    (t_s > t_e) wrap at template_length.
    """
    q_len = q_e - q_s
    t_len = t_e - t_s
    if t_len < 0:
        t_len += template_length
    q = query[q_s:q_e]
    if aligned is not None:
        aligned.start = 0
        aligned.end = 0
    if t_len == 0 or q_len == 0:
        return _empty_case(t_len, q_len, W1, U, q, template, t_e,
                           template_length, aligned)

    neg = (t_len + q_len) * (MM + U + W1)
    E = np.zeros((t_len + 1, q_len + 1), dtype=np.uint8)

    D_prev = np.empty(q_len + 1, dtype=np.int64)
    P_prev = np.full(q_len + 1, neg, dtype=np.int64)
    if 0 < k:
        E[:t_len, q_len] = 0
        if k == 1:
            D_prev[:q_len] = W1 + (q_len - 1 - np.arange(q_len)) * U
            E[t_len, :q_len] = 3
            E[t_len, q_len - 1] = 18
            E[t_len, q_len] = 0
            D_prev[q_len] = 0
            P_prev[q_len] = 0
        else:
            D_prev[:] = 0
            E[t_len, : q_len + 1] = 0
    else:
        E[:t_len, q_len] = 5
        E[t_len - 1, q_len] = 36  # E_ptr[-1] of the bottom row (nw.c:141)
        D_prev[:q_len] = W1 + (q_len - 1 - np.arange(q_len)) * U
        E[t_len, :q_len] = 3
        E[t_len, q_len - 1] = 18
        E[t_len, q_len] = 0
        D_prev[q_len] = 0
        P_prev[q_len] = 0

    # template nucleotides for rows m = t_len-1 .. 0 at nuc_pos = t_e-1 ..
    rows = np.arange(t_len - 1, -1, -1)
    nuc_pos = (t_e - 1 - (t_len - 1 - rows)) % template_length
    t_nucs = template[nuc_pos]

    best_score = neg
    best_m = 0
    D_bound_prev_row = D_prev[q_len]
    for ri, m in enumerate(rows.tolist()):
        D_boundary = 0 if 0 < k else (W1 + (t_len - 1 - m) * U)
        match_scores = d[t_nucs[ri], q].astype(np.int64)
        D_row, P_row, E_row = _row_step(
            np.concatenate((D_prev[:q_len], [D_bound_prev_row])),
            np.concatenate((P_prev[:q_len], [P_prev[q_len]])),
            D_boundary, match_scores, W1, U, neg, banded=False)
        E[m, :q_len] = E_row
        if k < 0 and best_score < D_row[0]:
            best_score = D_row[0]
            best_m = m
        D_prev[:q_len] = D_row
        D_prev[q_len] = D_boundary
        P_prev[:q_len] = P_row
        D_bound_prev_row = D_boundary

    st = AlnScore()
    pos0, pos1 = 0, 0
    if k < 0:
        st.score = best_score
        pos0 = best_m
        if k == -2:
            for n in range(q_len):
                if st.score <= D_prev[n]:
                    st.score = int(D_prev[n])
                    pos0 = 0
                    pos1 = n
            if aligned is not None:
                aligned.start = pos1
    else:
        st.score = int(D_prev[0])

    # traceback (nw.c:250-307)
    m, n = pos0, pos1
    nuc_pos = m + t_s
    out_t, out_s, out_q = [], [], []
    emit = aligned is not None
    while E[m, n] != 0:
        if nuc_pos == template_length:
            nuc_pos = 0
        b = int(E[m, n])
        op = b & 7
        if op == 1:
            if emit:
                tn = int(template[nuc_pos])
                qn = int(q[n])
                out_t.append(tn)
                out_q.append(qn)
                out_s.append(ord("|") if tn == qn else ord("_"))
            st.match += 1
            nuc_pos += 1
            m += 1
            n += 1
        elif op >= 4:
            while not (E[m, n] >> 4):
                if emit:
                    out_t.append(int(template[nuc_pos]))
                    out_q.append(5)
                    out_s.append(ord("_"))
                nuc_pos += 1
                m += 1
                st.len += 1
                st.qGaps += 1
            if emit:
                out_t.append(int(template[nuc_pos]))
                out_q.append(5)
                out_s.append(ord("_"))
            nuc_pos += 1
            m += 1
            st.qGaps += 1
        else:
            while not (E[m, n] >> 3):
                if emit:
                    out_t.append(5)
                    out_q.append(int(q[n]))
                    out_s.append(ord("_"))
                n += 1
                st.len += 1
                st.tGaps += 1
            if emit:
                out_t.append(5)
                out_q.append(int(q[n]))
                out_s.append(ord("_"))
            n += 1
            st.tGaps += 1
        st.len += 1
    if emit:
        aligned.t = np.array(out_t, dtype=np.uint8)
        aligned.s = np.array(out_s, dtype=np.uint8)
        aligned.q = np.array(out_q, dtype=np.uint8)
        aligned.end = q_len - n
    return st


def nw_band(template: np.ndarray, query: np.ndarray, k: int, t_s: int,
            t_e: int, q_s: int, q_e: int, band: int, d: np.ndarray, W1: int,
            U: int, MM: int, template_length: int,
            aligned: Optional[Aligned] = None) -> AlnScore:
    """NW_band / NW_band_score (nw.c:310-640 / 892-1188).

    The band is sheared along the (t+q)/2 diagonal; row cells are indexed
    n = 0..band with query position q_pos = sq - (sn - n).
    """
    q_len = q_e - q_s
    t_len = t_e - t_s
    if t_len < 0:
        t_len += template_length
    q = query[q_s:q_e]
    if aligned is not None:
        aligned.start = 0
        aligned.end = 0
    if t_len == 0 or q_len == 0:
        return _empty_case(t_len, q_len, W1, U, q, template, t_e,
                           template_length, aligned)

    if band & 1:
        band += 1
    halfBand = band >> 1
    bq_len = band + 1
    neg = (t_len + q_len) * (MM + U + W1)
    E = np.zeros((t_len + 1, bq_len + 1), dtype=np.uint8)

    D_prev = np.full(bq_len + 1, neg, dtype=np.int64)
    P_prev = np.full(bq_len + 1, neg, dtype=np.int64)
    D_ptr = np.full(bq_len + 1, neg, dtype=np.int64)
    P_ptr = np.full(bq_len + 1, neg, dtype=np.int64)

    c_pos = (t_len + q_len) >> 1
    sn0 = q_len - 1 - (c_pos - halfBand)
    if k != 2:
        ar = np.arange(sn0)
        D_prev[:sn0] = W1 + (sn0 - ar - 1) * U
        E[t_len, :sn0] = 3
        if sn0 >= 1:
            E[t_len, sn0 - 1] = 18
        E[t_len, sn0] = 0
        D_prev[sn0] = 0
        P_prev[sn0] = 0
    else:
        D_prev[: sn0 + 1] = 0
        E[t_len, : sn0 + 1] = 0

    pos0, pos1 = 0, 0
    en = 0
    best_score = neg
    have_best = False
    c_pos = (t_len + q_len) >> 1
    nuc_pos = t_e - 1
    en_final = 0
    for m in range(t_len - 1, -1, -1):
        if nuc_pos < 0:
            nuc_pos = template_length - 1
        sq = c_pos + halfBand
        eq = c_pos - halfBand
        if eq < 0:
            eq = 0
            en += 1
        else:
            en = 0

        if sq < (q_len - 1):
            sn = bq_len - 1
            D_ptr[bq_len] = neg
            E[m, bq_len] = 37
        else:
            sq = q_len - 1
            sn = en + (q_len - eq)
            D_ptr[sn] = 0 if 0 < k else (W1 + (t_len - 1 - m) * U)
            E[m, sn] = 0 if 0 < k else 37
            sn -= 1

        t_nuc = int(template[nuc_pos])
        # vectorised cells n in [en+1, sn], q_pos = sq - (sn - n)
        width = sn - en  # number of loop cells
        if width > 0:
            ns = np.arange(en + 1, sn + 1)
            qpos = sq - (sn - ns)
            Popen = D_prev[ns - 1] + W1
            Pext = P_prev[ns - 1] + U
            Msc = D_prev[ns] + d[t_nuc, q[qpos]].astype(np.int64)
            P = np.maximum(Popen, Pext)
            D0 = np.maximum(P, Msc)
            # Q suffix scan over the final D values; boundary source at sn+1
            Up = max(W1, U)
            b = np.empty(width + 1, dtype=np.int64)
            b[:width] = D0 + np.arange(width, dtype=np.int64) * Up
            b[width] = max(int(D_ptr[sn + 1]), neg + U - W1) + width * Up
            suf = np.maximum.accumulate(b[::-1])[::-1]
            rel = np.arange(width, dtype=np.int64)
            Q = suf[1:] - (rel + 1) * Up + W1
            Qopen = np.empty(width, dtype=np.int64)
            Qopen[:-1] = np.maximum(D0[1:], Q[1:]) + W1
            Qopen[-1] = int(D_ptr[sn + 1]) + W1
            Qext = np.empty(width, dtype=np.int64)
            Qext[:-1] = Q[1:] + U
            Qext[-1] = neg + U
            e = np.where(Qopen < Popen, 4, 2).astype(np.int64)
            Dr = np.maximum(Qopen, Popen)
            bit16 = ~(Qopen < Qext)
            upd3 = (Qopen < Qext) & (Dr <= Qext)
            Dr = np.where(upd3, Qext, Dr)
            e = np.where(upd3, 3, e)
            bit32 = ~(Popen < Pext)
            upd5 = (Popen < Pext) & (Dr <= Pext)
            Dr = np.where(upd5, Pext, Dr)
            e = np.where(upd5, 5, e)
            bit1 = Dr <= Msc
            Dfin = np.maximum(Dr, Msc)
            E[m, ns] = (bit16 * 16 + bit32 * 32
                        + np.where(bit1, 1, e)).astype(np.uint8)
            D_ptr[ns] = Dfin
            P_ptr[ns] = P
            q_en = int(Q[0])  # Q value at n = en+1 feeds the boundary cell
            d_en1 = int(Dfin[0])
        else:
            q_en = neg
            d_en1 = int(D_ptr[sn + 1]) if sn + 1 <= bq_len else neg
            # mirror Q_prev init when loop is empty
            q_en = None

        # boundary cell n = en (nw.c:513-539)
        n = en
        q_pos = sq - (sn - n)
        Ebits = 0
        Qb = int(D_ptr[n + 1]) + W1
        ext = (q_en if q_en is not None else neg) + U
        if Qb < ext:
            Qb = ext
            eb = 3
        else:
            eb = 2
            Ebits |= 16
        P_ptr[n] = neg
        Db = int(D_prev[n]) + int(d[t_nuc, q[q_pos]])
        if Qb <= Db:
            Ebits |= 1
        else:
            Db = Qb
            Ebits |= eb
        D_ptr[n] = Db
        E[m, n] = Ebits

        if eq == 0 and k < 0 and best_score < Db:
            best_score = Db
            pos0, pos1 = m, n
            have_best = True

        D_prev, D_ptr = D_ptr, D_prev
        P_prev, P_ptr = P_ptr, P_prev
        nuc_pos -= 1
        c_pos -= 1
        en_final = en

    st = AlnScore()
    q_pos = 0
    if pos0 == 0:
        pos1 = en_final
        st.score = int(D_prev[en_final])
    else:
        st.score = best_score
    if k == -2:
        for n in range(en_final, bq_len):
            if st.score <= D_prev[n]:
                st.score = int(D_prev[n])
                pos0 = 0
                pos1 = n
                q_pos = (n - en_final) if aligned is not None else n
    if aligned is not None:
        aligned.start = q_pos

    # back tracking (nw.c:578-637)
    m, n = pos0, pos1
    nuc_pos = m + t_s
    out_t, out_s, out_q = [], [], []
    emit = aligned is not None
    while E[m, n] != 0:
        if nuc_pos == template_length:
            nuc_pos = 0
        op = int(E[m, n]) & 7
        if op == 1:
            if emit:
                tn = int(template[nuc_pos])
                qn = int(q[q_pos])
                out_t.append(tn)
                out_q.append(qn)
                out_s.append(ord("|") if tn == qn else ord("_"))
            st.match += 1
            nuc_pos += 1
            m += 1
            q_pos += 1
        elif op >= 4:
            while not (E[m, n] >> 4):
                if emit:
                    out_t.append(int(template[nuc_pos]))
                    out_q.append(5)
                    out_s.append(ord("_"))
                nuc_pos += 1
                m += 1
                n -= 1
                st.len += 1
                st.qGaps += 1
            if emit:
                out_t.append(int(template[nuc_pos]))
                out_q.append(5)
                out_s.append(ord("_"))
            nuc_pos += 1
            m += 1
            n -= 1
            st.qGaps += 1
        else:
            while not (E[m, n] >> 3):
                if emit:
                    out_t.append(5)
                    out_q.append(int(q[q_pos]))
                    out_s.append(ord("_"))
                n += 1
                q_pos += 1
                st.len += 1
                st.tGaps += 1
            if emit:
                out_t.append(5)
                out_q.append(int(q[q_pos]))
                out_s.append(ord("_"))
            n += 1
            q_pos += 1
            st.tGaps += 1
        st.len += 1
    if emit:
        aligned.t = np.array(out_t, dtype=np.uint8)
        aligned.s = np.array(out_s, dtype=np.uint8)
        aligned.q = np.array(out_q, dtype=np.uint8)
        aligned.end = q_len - q_pos
    return st

"""ctypes bridge to the native step-3 aligner (native/kma_align.cpp).

The C++ engine is an exact port of this package's kma_aln/nw/cci modules
(which remain the semantics reference and the fallback when no compiler
is available).  It removes the per-(read, template) interpreter overhead
from alnFrags/assembly: ~0.7 ms -> ~2 us per alignment.

The engine keeps one global seed buffer mirroring the reference's
per-thread AlnPoints (alnfrags.c); the mapping pipeline is
single-threaded per process, so the Python wrapper only mirrors the
seed COUNT onto the caller's Points object (whose arrays stay empty --
nothing outside kma_aln reads them).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import weakref
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native")
_SRC = os.path.join(_NATIVE_DIR, "kma_align.cpp")
_SO = os.path.join(_NATIVE_DIR, "libkma_align.so")

_lib = None
_tried = False


class _Stat(ctypes.Structure):
    _fields_ = [("score", ctypes.c_longlong),
                ("pos", ctypes.c_int),
                ("len", ctypes.c_int),
                ("match", ctypes.c_int),
                ("tGaps", ctypes.c_int),
                ("qGaps", ctypes.c_int),
                ("mapQ", ctypes.c_int)]


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    for extra in (["-march=native"], []):
        try:
            subprocess.run(
                ["g++", "-O2", "-fPIC", "-shared"] + extra
                + ["-o", _SO + ".tmp"] + [_SRC, os.path.join(_NATIVE_DIR, "kma_assem.cpp")],
                check=True, capture_output=True)
            os.replace(_SO + ".tmp", _SO)
            return True
        except Exception as e:
            err = e
    print(f"# native aligner build failed: {err}", file=sys.stderr)
    return False


def get_lib():
    """Load (building if needed) the native aligner; None if unavailable.

    Set KMA_TPU_NO_NATIVE=1 to force the Python fallback."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("KMA_TPU_NO_NATIVE"):
        return None
    if (not os.path.exists(_SO)
            or (os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_SO))):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as e:  # pragma: no cover
        print(f"# native aligner load failed: {e}", file=sys.stderr)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    if os.environ.get("KMA_ALN_PROF"):
        import atexit
        atexit.register(lib.kaln_prof_report)
    lib.kidx_create.restype = ctypes.c_void_p
    lib.kidx_create.argtypes = [u8p, ctypes.c_int, ctypes.c_int]
    lib.kidx_free.argtypes = [ctypes.c_void_p]
    lib.kaln_set_exhaustive.argtypes = [ctypes.c_int]
    lib.kaln_align.restype = ctypes.c_int
    lib.kaln_align.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(_Stat)]
    lib.kaln_aligned_len.restype = ctypes.c_int
    lib.kaln_aligned_fetch.argtypes = [u8p, u8p, u8p, i32p]
    lib.kaln_anker_rc_comp.restype = ctypes.c_int
    lib.kaln_anker_rc_comp.argtypes = [
        ctypes.c_void_p, u8p, u8p, i32p, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p]
    lib.kaln_anker_rc_bytes.restype = ctypes.c_int
    lib.kaln_anker_rc_bytes.argtypes = [
        ctypes.c_void_p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p]
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.kaln_set_circular.restype = None
    lib.kaln_set_circular.argtypes = [ctypes.c_int]
    lib.kaln_frags_se_batch_crc.restype = None
    lib.kaln_frags_se_batch_crc.argtypes = [
        vpp, i32p, i64p,                 # handles, tpl ids, tpl offsets
        u8p, i64p,                       # codes flat, offsets
        i32p, i64p,                      # npos flat, offsets
        i32p, u8p,                       # qbounds, arc flags
        u8p, i64p, ctypes.c_int,         # custom rc flat/off, n_reads
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        i32p, i64p, f64p,                # nhits, best_score, best_frac
        i32p, i32p, i32p, i64p, i32p]    # tpl, start, end, score, len
    lib.kaln_frags_se_batch_mf.restype = None
    lib.kaln_frags_se_batch_mf.argtypes = \
        lib.kaln_frags_se_batch_crc.argtypes[:23] \
        + [ctypes.c_double] \
        + lib.kaln_frags_se_batch_crc.argtypes[23:]
    lib.kaln_frags_se_batch.restype = None
    lib.kaln_frags_se_batch.argtypes = [
        vpp, i32p, i64p,                 # handles, tpl ids, tpl offsets
        u8p, i64p,                       # codes flat, offsets
        i32p, i64p,                      # npos flat, offsets
        i32p, u8p, ctypes.c_int,         # qbounds, arc flags, n_reads
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        i32p, i64p, f64p,                # nhits, best_score, best_frac
        i32p, i32p, i32p, i64p, i32p]    # tpl, start, end, score, len
    lib.kaln_set_dev_scores.restype = None
    lib.kaln_set_dev_scores.argtypes = [i64p, u8p, i64p, u8p]
    lib.kaln_se_windows.restype = ctypes.c_longlong
    lib.kaln_se_windows.argtypes = [
        vpp, i32p, i64p,                 # handles, tpl ids, tpl offsets
        u8p, i64p, i32p, i64p,           # codes, npos
        i32p, u8p, u8p, i64p,            # qbounds, arc, crc
        ctypes.c_int,                    # n_reads
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        i32p, i32p, u8p, i32p, i32p, i32p, i32p, i32p, i32p,
        i32p, i32p]                      # lead_win, trail_win
    lib.kaln_se_stage_codes.restype = None
    lib.kaln_se_stage_codes.argtypes = [
        vpp, u8p, i64p, u8p, i64p,
        i32p, i32p, u8p, i32p, i32p, i32p, i32p, i32p, i32p,
        i64p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        u8p, u8p, u8p, i32p, i32p, i32p, i32p]
    lib.kassem_set_pileup_export.restype = None
    lib.kassem_set_pileup_export.argtypes = [
        u8p, u8p, i64p, i32p, ctypes.c_longlong, ctypes.c_longlong]
    lib.kassem_pileup_export_take.restype = None
    lib.kassem_pileup_export_take.argtypes = [
        i64p, i64p, ctypes.POINTER(ctypes.c_int)]
    lib.kaln_pe_score_batch.restype = None
    lib.kaln_pe_score_batch.argtypes = [
        vpp, i32p, i64p,                 # handles, tpl ids, tpl offsets
        u8p, i64p, u8p, i64p,            # mate1/mate2 codes + offsets
        u8p, ctypes.c_int,               # arc flags, n_pairs
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int, ctypes.c_int,      # mq, threads
        i64p, i32p, i32p, i32p, i32p,    # sc1, pos1, len1, tg1, qg1
        i64p, i32p, i32p, i32p, i32p,    # sc2, pos2, len2, tg2, qg2
        u8p,                             # flipped
        ctypes.c_int, ctypes.c_double]   # arc minlen/mrc gates
    lib.kassem_template_frags.restype = ctypes.c_longlong
    lib.kassem_template_frags.argtypes = [
        ctypes.c_void_p, u8p, i64p,
        i32p, i32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i64p, i64p, ctypes.c_longlong, ctypes.c_int,
        u8p, u8p, i64p, i64p, i32p, i32p, i32p]
    _lib = lib
    return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


_EMPTY_I32 = np.empty(0, dtype=np.int32)
_EMPTY_U8 = np.empty(0, dtype=np.uint8)


def native_handle(tindex):
    """Lazily build (and cache on the TemplateIndex) a native index."""
    h = getattr(tindex, "native", None)
    if h is not None:
        return h
    lib = get_lib()
    codes = np.ascontiguousarray(tindex.codes, dtype=np.uint8)
    h = lib.kidx_create(_u8p(codes), len(codes), tindex.kmerindex)
    tindex.native = h
    weakref.finalize(tindex, lib.kidx_free, h)
    return h


def _as_i32(a) -> np.ndarray:
    if a is None:
        return _EMPTY_I32
    return np.ascontiguousarray(a, dtype=np.int32)


_d_cache = {}
_pe_scratch: dict = {}


def _dmat(d: np.ndarray) -> np.ndarray:
    key = id(d)
    got = _d_cache.get(key)
    if got is None:
        got = np.ascontiguousarray(d[:5, :5], dtype=np.int32)
        _d_cache[key] = got
    return got


def kma_align(tindex, qseq, q_len, q_start, q_end, lo, hi, mq, rew, points,
              traceback, n_positions=None, circular=False, ts=0,
              skip_tails=False):
    """Native KMA()/KMA_score; mirrors kma_aln.kma_align's return."""
    from .nw import Aligned, AlnScore

    lib = get_lib()
    h = native_handle(tindex)
    q = np.ascontiguousarray(qseq, dtype=np.uint8)
    npos = _as_i32(n_positions)
    d = _dmat(rew.d)
    st = _Stat()
    use_points = 1 if points.len else 0
    lib.kaln_align(h, _u8p(q), q_len, q_start, q_end, lo, hi, mq,
                   rew.M, rew.MM, rew.U, rew.W1, _i32p(d), _i32p(npos),
                   len(npos), 1 if traceback else 0, use_points,
                   1 if circular else 0, ts, 1 if skip_tails else 0,
                   ctypes.byref(st))
    points.len = 0
    stat = AlnScore(score=int(st.score), pos=st.pos, len=st.len,
                    match=st.match, tGaps=st.tGaps, qGaps=st.qGaps)
    aligned = None
    if traceback:
        n = lib.kaln_aligned_len()
        t = np.empty(n, np.uint8)
        s = np.empty(n, np.uint8)
        qq = np.empty(n, np.uint8)
        se = np.zeros(2, np.int32)
        lib.kaln_aligned_fetch(_u8p(t), _u8p(s), _u8p(qq), _i32p(se))
        aligned = Aligned(t=t, s=s, q=qq, start=int(se[0]), end=int(se[1]),
                          pos=tindex.len, mapQ=st.mapQ)
    return stat, aligned, st.mapQ


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def frags_se_batch(handles: np.ndarray, tpl_ids: np.ndarray,
                   tpl_off: np.ndarray, codes_flat: np.ndarray,
                   codes_off: np.ndarray, npos_flat: np.ndarray,
                   npos_off: np.ndarray, qbounds: np.ndarray,
                   arc_flags: np.ndarray, rew, kmersize: int, minlen: int,
                   mq: int, scoreT: float, mrc: float, n_threads: int,
                   crc_flat=None, crc_off=None, min_frac: float = None):
    """Threaded native alnFragsSE over a read batch (alnfrags.c:1052-1218,
    2150-2293).  Returns (n_hits [n], best_score i64 [n], best_frac f64 [n],
    tpl/start/end/score/length flat arrays; read r's hits live at
    tpl_off[r] .. tpl_off[r]+n_hits[r]).

    ``min_frac`` is the downstream update_Scores selection's minFrac;
    passing it (1.0 for the default selection) lets the native scorer
    skip candidates whose score bound proves they cannot be selected."""
    lib = get_lib()
    n = len(arc_flags)
    total = int(tpl_off[-1])
    d = _dmat(rew.d)
    out_nhits = np.zeros(n, np.int32)
    out_best = np.zeros(n, np.int64)
    out_frac = np.zeros(n, np.float64)
    out_tpl = np.zeros(total, np.int32)
    out_start = np.zeros(total, np.int32)
    out_end = np.zeros(total, np.int32)
    out_score = np.zeros(total, np.int64)
    out_len = np.zeros(total, np.int32)
    if crc_flat is None:
        crc_flat = _EMPTY_U8
        crc_off = np.zeros(n + 1, np.int64)
    lib.kaln_frags_se_batch_mf(
        handles.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        _i32p(tpl_ids), _i64p(tpl_off), _u8p(codes_flat), _i64p(codes_off),
        _i32p(npos_flat), _i64p(npos_off), _i32p(qbounds), _u8p(arc_flags),
        _u8p(crc_flat), _i64p(crc_off),
        n, rew.M, rew.MM, rew.U, rew.W1, _i32p(d), kmersize, minlen, mq,
        scoreT, mrc, n_threads,
        float("nan") if min_frac is None else float(min_frac),
        _i32p(out_nhits), _i64p(out_best),
        out_frac.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _i32p(out_tpl), _i32p(out_start), _i32p(out_end), _i64p(out_score),
        _i32p(out_len))
    return (out_nhits, out_best, out_frac, out_tpl, out_start, out_end,
            out_score, out_len)


_EMPTY_I64 = np.zeros(0, np.int64)


def se_windows(handles, tpl_ids, tpl_off, codes_flat, codes_off,
               npos_flat, npos_off, qbounds, arc_flags, rew,
               kmersize: int, mq: int, scoreT: float,
               est_cells_min: int = 1 << 15, max_band: int = 126,
               crc_flat=None, crc_off=None):
    """Export the heavy lead/trail banded windows of an SE batch for the
    device pre-pass (kaln_se_windows; nw.c:892 window role).  Returns
    (wins dict of per-window arrays, lead_win i32 [total], trail_win
    i32 [total]) or None when no window qualifies."""
    lib = get_lib()
    n = len(arc_flags)
    total = int(tpl_off[-1])
    d = _dmat(rew.d)
    if crc_flat is None:
        crc_flat = _EMPTY_U8
        crc_off = np.zeros(n + 1, np.int64)
    lead_win = np.empty(total, np.int32)
    trail_win = np.empty(total, np.int32)
    cap = max(1024, 2 * n)
    while True:
        w_read = np.empty(cap, np.int32)
        w_cand = np.empty(cap, np.int32)
        w_rc = np.empty(cap, np.uint8)
        w_ts = np.empty(cap, np.int32)
        w_te = np.empty(cap, np.int32)
        w_qs = np.empty(cap, np.int32)
        w_qe = np.empty(cap, np.int32)
        w_kf = np.empty(cap, np.int32)
        w_band = np.empty(cap, np.int32)
        got = lib.kaln_se_windows(
            handles.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
            _i32p(tpl_ids), _i64p(tpl_off), _u8p(codes_flat),
            _i64p(codes_off), _i32p(npos_flat), _i64p(npos_off),
            _i32p(qbounds), _u8p(arc_flags), _u8p(crc_flat),
            _i64p(crc_off), n, rew.M, rew.MM, rew.U, rew.W1, _i32p(d),
            kmersize, mq, scoreT, est_cells_min, max_band, cap,
            _i32p(w_read), _i32p(w_cand), _u8p(w_rc), _i32p(w_ts),
            _i32p(w_te), _i32p(w_qs), _i32p(w_qe), _i32p(w_kf),
            _i32p(w_band), _i32p(lead_win), _i32p(trail_win))
        if got >= 0:
            break
        cap = int(-got) + 64
    nw = int(got)
    if nw == 0:
        return None
    wins = {"read": w_read[:nw], "cand": w_cand[:nw], "rc": w_rc[:nw],
            "ts": w_ts[:nw], "te": w_te[:nw], "qs": w_qs[:nw],
            "qe": w_qe[:nw], "kf": w_kf[:nw], "band": w_band[:nw]}
    return wins, lead_win, trail_win


def arm_pileup_export(n_rows: int, cap_bytes: int):
    """Arm the dense-assembly device-pileup export for the NEXT
    assembly_frags_batch call; returns the buffers to keep alive."""
    lib = get_lib()
    p_t = np.empty(cap_bytes, np.uint8)
    p_q = np.empty(cap_bytes, np.uint8)
    p_off = np.zeros(n_rows + 1, np.int64)
    p_start = np.zeros(max(n_rows, 1), np.int32)
    lib.kassem_set_pileup_export(
        _u8p(p_t), _u8p(p_q), _i64p(p_off), _i32p(p_start), cap_bytes,
        n_rows)
    return p_t, p_q, p_off, p_start


def take_pileup_export():
    """(n_rows, used_bytes, overflowed) of the armed export; disarms."""
    lib = get_lib()
    pr = np.zeros(2, np.int64)
    over = ctypes.c_int(0)
    lib.kassem_pileup_export_take(_i64p(pr[0:]), _i64p(pr[1:]),
                                  ctypes.byref(over))
    return int(pr[0]), int(pr[1]), bool(over.value)


def stage_codes(handles, codes_flat, codes_off, crc_flat, crc_off,
                wins, sel, R: int, L: int):
    """Code staging for the device NW scorer (kaln_se_stage_codes).
    Returns (qc0 [n, L] u8, tcol [R, n] u8, inj [R, n] u8, tl, ql, kf,
    hb)."""
    lib = get_lib()
    if crc_flat is None:
        crc_flat = _EMPTY_U8
        crc_off = np.zeros(len(codes_off), np.int64)
    sel = np.ascontiguousarray(sel, np.int64)
    n = len(sel)
    qc0 = np.empty((n, L), np.uint8)
    tcol = np.empty((R, n), np.uint8)
    inj = np.empty((R, n), np.uint8)
    tl = np.empty(n, np.int32)
    ql = np.empty(n, np.int32)
    kf = np.empty(n, np.int32)
    hb = np.empty(n, np.int32)
    lib.kaln_se_stage_codes(
        handles.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        _u8p(codes_flat), _i64p(codes_off), _u8p(crc_flat),
        _i64p(crc_off), _i32p(wins["read"]),
        _i32p(wins["cand"]), _u8p(wins["rc"]), _i32p(wins["ts"]),
        _i32p(wins["te"]), _i32p(wins["qs"]), _i32p(wins["qe"]),
        _i32p(wins["kf"]), _i32p(wins["band"]), _i64p(sel), n, R, L,
        _u8p(qc0), _u8p(tcol), _u8p(inj), _i32p(tl),
        _i32p(ql), _i32p(kf), _i32p(hb))
    return qc0, tcol, inj, tl, ql, kf, hb


def set_dev_scores(lead, has_lead, trail, has_trail):
    """Arm the device pre-pass score tables for the NEXT
    frags_se_batch call (cleared by it).  The caller must keep the
    arrays alive until that call returns."""
    lib = get_lib()
    if lead is None:
        nullp = ctypes.POINTER(ctypes.c_int64)()
        nullb = ctypes.POINTER(ctypes.c_uint8)()
        lib.kaln_set_dev_scores(nullp, nullb, nullp, nullb)
        return
    lib.kaln_set_dev_scores(_i64p(lead), _u8p(has_lead), _i64p(trail),
                            _u8p(has_trail))


def anker_rc_comp(tindex, qseq, qseq_r, n_pos_f, n_pos_r, q_len, q_start,
                  q_end, points, one2one):
    lib = get_lib()
    h = native_handle(tindex)
    q = np.ascontiguousarray(qseq, dtype=np.uint8)
    qr = np.ascontiguousarray(qseq_r, dtype=np.uint8)
    nf = _as_i32(n_pos_f)
    nr = _as_i32(n_pos_r)
    n_out = np.zeros(1, np.int32)
    res = lib.kaln_anker_rc_comp(h, _u8p(q), _u8p(qr), _i32p(nf), len(nf),
                                 _i32p(nr), len(nr), q_len, q_start, q_end,
                                 one2one, _i32p(n_out))
    points.len = int(n_out[0])
    return res


def anker_rc_bytes(tindex, qseq, qseq_r, q_len, q_start, q_end, points,
                   one2one):
    lib = get_lib()
    h = native_handle(tindex)
    q = np.ascontiguousarray(qseq, dtype=np.uint8)
    qr = np.ascontiguousarray(qseq_r, dtype=np.uint8)
    n_out = np.zeros(1, np.int32)
    res = lib.kaln_anker_rc_bytes(h, _u8p(q), _u8p(qr), q_len, q_start,
                                  q_end, one2one, _i32p(n_out))
    points.len = int(n_out[0])
    return res


def pe_score_batch(handles: np.ndarray, tpl_ids: np.ndarray,
                   tpl_off: np.ndarray, a_flat, a_off, b_flat, b_off,
                   arcs: np.ndarray, rew, mq: int, threads: int,
                   minlen: int = 16, mrc: float = 0.0):
    """Batched PE mate scoring (alnFrags*PE inner loops): raw per-mate
    AlnStat fields per (pair, template) slot; tpl_ids is sign-mutated in
    place by the arc orientation picks.  Returns (sc1, pos1, len1, tg1,
    qg1, sc2, pos2, len2, tg2, qg2, flipped)."""
    lib = get_lib()
    n_pairs = len(arcs)
    total = int(tpl_off[-1])
    # reusable scratch (the caller consumes the views before the next
    # call; the pipeline is single-threaded on the Python side)
    sc = _pe_scratch
    if sc.get("cap", -1) < total or sc.get("pcap", -1) < n_pairs:
        cap = max(256, 2 * total)
        pcap = max(64, 2 * n_pairs)
        sc["cap"] = cap
        sc["pcap"] = pcap
        sc["i64"] = [np.zeros(cap, np.int64) for _ in range(2)]
        sc["i32"] = [np.zeros(cap, np.int32) for _ in range(8)]
        sc["u8"] = np.zeros(pcap, np.uint8)
    sc1, sc2 = (a[:total] for a in sc["i64"])
    pos1, len1, tg1, qg1, pos2, len2, tg2, qg2 = \
        (a[:total] for a in sc["i32"])
    flipped = sc["u8"][:n_pairs]
    i64pp = ctypes.POINTER(ctypes.c_int64)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    d = _dmat(rew.d)
    lib.kaln_pe_score_batch(
        handles.ctypes.data_as(vpp), _i32p(tpl_ids),
        tpl_off.ctypes.data_as(i64pp),
        _u8p(a_flat), a_off.ctypes.data_as(i64pp),
        _u8p(b_flat), b_off.ctypes.data_as(i64pp),
        _u8p(arcs), n_pairs,
        rew.M, rew.MM, rew.U, rew.W1, _i32p(d),
        mq, max(1, threads),
        sc1.ctypes.data_as(i64pp), _i32p(pos1), _i32p(len1), _i32p(tg1),
        _i32p(qg1),
        sc2.ctypes.data_as(i64pp), _i32p(pos2), _i32p(len2), _i32p(tg2),
        _i32p(qg2),
        _u8p(flipped), int(minlen), float(mrc))
    return (sc1, pos1, len1, tg1, qg1, sc2, pos2, len2, tg2, qg2, flipped)


def assembly_frags_batch(tindex, codes_flat, codes_off, qbounds, fstats,
                         n, rew, Wl_raw, minlen, mq, scoreT, mrc,
                         circular, ts, skip_tails, dense, counts, nxt,
                         mat_len, t_len):
    """assemble_KMA's frag loop (assembly.c:1689-2127) for one template,
    applied directly to the assembly matrix; returns (new_mat_len, acc,
    rc_used, read_score, mat_score, start, end, aln_len)."""
    lib = get_lib()
    h = native_handle(tindex)
    acc = np.zeros(n, np.uint8)
    rcu = np.zeros(n, np.uint8)
    rs = np.zeros(n, np.int64)
    ms = np.zeros(n, np.int64)
    st = np.zeros(n, np.int32)
    en = np.zeros(n, np.int32)
    ln = np.zeros(n, np.int32)
    i64pp = ctypes.POINTER(ctypes.c_int64)
    d = _dmat(rew.d)
    new_len = lib.kassem_template_frags(
        h, _u8p(codes_flat), codes_off.ctypes.data_as(i64pp),
        _i32p(qbounds), _i32p(fstats), n,
        rew.M, rew.MM, rew.U, rew.W1, _i32p(d), Wl_raw,
        minlen, mq, scoreT, mrc,
        1 if circular else 0, ts, 1 if skip_tails else 0,
        1 if dense else 0,
        counts.ctypes.data_as(i64pp), nxt.ctypes.data_as(i64pp),
        mat_len, t_len,
        _u8p(acc), _u8p(rcu), rs.ctypes.data_as(i64pp),
        ms.ctypes.data_as(i64pp), _i32p(st), _i32p(en), _i32p(ln))
    return new_len, acc, rcu, rs, ms, st, en, ln

"""ctypes bridge to the fused native SE run driver (native/kma_run.cpp).

One native call per read batch covers the whole hot path of runKMA
(reference runkma.c:130-908): step-2 scan, step-3 candidate scoring, the
update_Scores spool and ConClave — the per-read Python glue of
pipeline.run_kma collapses to a handful of batch calls.  libkma_run.so
links kma_chain.cpp + kma_align.cpp + kma_run.cpp into one library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

import numpy as np

from .config import MapConfig, Penalties
from .index.format import KmaIndex

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
_SRCS = [os.path.join(_NATIVE_DIR, f)
         for f in ("kma_chain.cpp", "kma_align.cpp", "kma_assem.cpp", "kma_run.cpp")]
_SO = os.path.join(_NATIVE_DIR, "libkma_run.so")

_lib = None
_tried = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_longlong)
_vp = ctypes.c_void_p


def _build() -> bool:
    if not all(os.path.exists(s) for s in _SRCS):
        return False
    for extra in (["-march=native"], []):
        try:
            subprocess.run(
                ["g++", "-O2", "-fPIC", "-shared"] + extra
                + ["-o", _SO + ".tmp"] + _SRCS + ["-lpthread"],
                check=True, capture_output=True)
            os.replace(_SO + ".tmp", _SO)
            _build_cli(extra)
            return True
        except Exception as e:
            err = e
    print(f"# native run-driver build failed: {err}", file=sys.stderr)
    return False


def _build_cli(extra) -> None:
    """Also refresh the native CLI fast-path binary (bin/kma execs it for
    plain host-path runs; exit 113 falls back to this Python CLI)."""
    cli_src = os.path.join(_NATIVE_DIR, "kma_cli.cpp")
    cli_bin = os.path.join(_NATIVE_DIR, "kma_cli")
    if not os.path.exists(cli_src):
        return
    try:
        subprocess.run(
            ["g++", "-O2"] + extra
            + ["-o", cli_bin + ".tmp", cli_src] + _SRCS
            + [os.path.join(_NATIVE_DIR, "kma_io.cpp"),
               os.path.join(_NATIVE_DIR, "kma_devclient.cpp"),
               "-lpthread", "-lz"],
            check=True, capture_output=True)
        os.replace(cli_bin + ".tmp", cli_bin)
    except Exception as e:  # pragma: no cover - CLI stays Python-only
        print(f"# native cli build failed: {e}", file=sys.stderr)


def get_lib():
    """Load (building if needed) the fused run driver; None if
    unavailable.  KMA_TPU_NO_NATIVE=1 forces the Python pipeline."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("KMA_TPU_NO_NATIVE"):
        return None
    watch = _SRCS + [os.path.join(_NATIVE_DIR, f)
                     for f in ("kma_io.cpp", "kma_devclient.cpp",
                               "kma_devclient.h", "kma_cli.cpp")]
    newest = max((os.path.getmtime(s) for s in watch
                  if os.path.exists(s)), default=0)
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as e:  # pragma: no cover
        print(f"# native run-driver load failed: {e}", file=sys.stderr)
        return None
    lib.krun_create.restype = _vp
    lib.krun_create.argtypes = [
        _vp, ctypes.c_int, _vp, ctypes.c_int, _vp, ctypes.c_int,
        _vp, ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        _i64p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, _i32p,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_longlong, ctypes.c_int,
    ]
    lib.krun_free.argtypes = [_vp]
    lib.krun_map_se_batch.restype = ctypes.c_longlong
    lib.krun_map_se_batch.argtypes = [
        _vp, _u8p, _i64p, _u8p, _i64p, _i64p, ctypes.c_int]
    lib.krun_scores.argtypes = [_vp, _i64p, _i64p]
    lib.krun_scores_set.argtypes = [_vp, _i64p, _i64p]
    lib.krun_ragged_gather.argtypes = [_u8p, _i64p, _i64p,
                                       ctypes.c_longlong, _u8p]
    lib.krun_spool_import.argtypes = [
        _vp, ctypes.c_longlong, _i32p, _i32p, _i64p, _i32p, _i64p,
        _i32p, _i32p, _i32p, _i64p, _u8p, _i64p, _u8p, _i64p, _u8p,
        _i64p, _u8p, _i64p, _i32p]
    lib.krun_conclave.argtypes = [
        _vp, ctypes.c_int, ctypes.c_int, _i64p, _i64p, _i64p,
        ctypes.c_longlong, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_longlong]
    lib.krun_stage_meta.argtypes = [_vp, ctypes.c_longlong, _i64p, _i64p,
                                    _i64p]
    lib.krun_stage_fill.argtypes = [
        _vp, ctypes.c_longlong, _i32p, _i32p, _i64p, _i32p, _i32p, _i32p,
        _u8p, _i64p, _u8p, _i64p]
    lib.krun_template_handle.restype = _vp
    lib.krun_template_handle.argtypes = [_vp, ctypes.c_longlong]
    lib.krun_spool_len.restype = ctypes.c_longlong
    lib.krun_spool_len.argtypes = [_vp]
    lib.krun_spool_meta.argtypes = [_vp, _i64p, _i64p, _i64p, _i64p,
                                    _i64p, _i64p]
    lib.krun_spool_fill.argtypes = [
        _vp, _i32p, _i32p, _i64p, _i32p, _i64p, _i32p, _i32p, _i32p,
        _i64p, _u8p, _i64p, _u8p, _i64p, _u8p, _i64p, _u8p, _i64p, _i32p]
    lib.krun_map_pe_batch.restype = ctypes.c_longlong
    lib.krun_map_pe_batch.argtypes = [
        _vp, _u8p, _i64p, _u8p, _i64p, _u8p, _i64p, _u8p, _i64p,
        _u8p, _i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i64p, _i64p, _i64p, _i64p, ctypes.c_longlong]
    lib.krun_set_pe.argtypes = [_vp, ctypes.c_longlong]
    lib.krun_set_mem.argtypes = [_vp, ctypes.c_int]
    lib.krun_assemble_template.restype = ctypes.c_longlong
    lib.krun_assemble_template.argtypes = [
        _vp, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i64p, _i64p, ctypes.c_longlong, ctypes.c_longlong,
        _u8p, ctypes.c_longlong,
        _i64p, _i64p, _i64p, _u8p, ctypes.c_longlong, _i64p]
    lib.kassem_set_pileup_export.restype = None
    lib.kassem_set_pileup_export.argtypes = [
        _u8p, _u8p, _i64p, _i32p, ctypes.c_longlong, ctypes.c_longlong]
    lib.kassem_pileup_export_take.restype = None
    lib.kassem_pileup_export_take.argtypes = [
        _i64p, _i64p, ctypes.POINTER(ctypes.c_int)]
    lib.krun_output_all.restype = ctypes.c_longlong
    lib.krun_output_all.argtypes = [
        _vp, _i64p, _u8p, _i64p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _i64p, _i64p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i64p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p]
    lib.krun_output_fetch.argtypes = [_vp, _u8p, _u8p, _u8p, _u8p, _u8p,
                                      _u8p, _u8p]
    lib.krun_output_nseg.restype = ctypes.c_longlong
    lib.krun_output_nseg.argtypes = [_vp]
    lib.krun_output_segments.argtypes = [_vp, _i32p, _i64p]
    _lib = lib
    return _lib


def _es(a: np.ndarray) -> int:
    return a.dtype.itemsize


class RunDriver:
    """Fused native run over one DB (SE -1t1 / chain modes)."""

    def __init__(self, lib, idx: KmaIndex, pen: Penalties,
                 template_lengths: np.ndarray, seq_path: str,
                 cfg: MapConfig, mode: int, aln_min_frac: float,
                 contamination: Optional[int]):
        self._lib = lib
        self._idx = idx
        # pin contiguous index views for the driver's lifetime
        self._exist = np.ascontiguousarray(idx.exist)
        self._values = np.ascontiguousarray(idx.values)
        if idx.mega:
            self._keyi = np.zeros(1, np.uint32)
            self._vali = np.zeros(1, np.uint32)
        else:
            self._keyi = np.ascontiguousarray(idx.key_index)
            self._vali = np.ascontiguousarray(idx.value_index)
        self._tl = np.ascontiguousarray(template_lengths, np.int64)
        self._d = np.ascontiguousarray(
            pen.score_matrix()[:5, :5], np.int32)
        self.db_size = int(idx.db_size)
        self._h = lib.krun_create(
            self._exist.ctypes.data_as(_vp), _es(self._exist),
            self._keyi.ctypes.data_as(_vp), _es(self._keyi),
            self._vali.ctypes.data_as(_vp), _es(self._vali),
            self._values.ctypes.data_as(_vp), _es(self._values),
            int(idx.null_index), int(idx.size - 1), int(idx.mask),
            1 if idx.mega else 0, 1 if idx.flag else 0,
            int(idx.flag & 3), int(idx.kmersize), int(idx.mlen),
            self._tl.ctypes.data_as(_i64p), len(self._tl), self.db_size,
            pen.M, pen.MM, pen.U, pen.W1, pen.Wl,
            self._d.ctypes.data_as(_i32p),
            seq_path.encode(), mode,
            1 if cfg.exhaustive else 0, cfg.min_len, cfg.mq,
            cfg.score_t, cfg.mrc, cfg.cover_t, 1 if cfg.lc else 0,
            aln_min_frac,
            -1 if contamination is None else int(contamination),
            max(1, cfg.threads))
        if not self._h:
            raise OSError("krun_create failed")
        lib.krun_set_pe(self._h, pen.PE)
        if cfg.mem_mode:
            lib.krun_set_mem(self._h, 1)

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            if getattr(self, "_h", None):
                self._lib.krun_free(self._h)
                self._h = None
        except Exception:
            pass

    def map_batch(self, codes_flat: np.ndarray, coff: np.ndarray,
                  hdr_flat: np.ndarray, hoff: np.ndarray,
                  ords: np.ndarray) -> int:
        n = len(coff) - 1
        if n <= 0:
            return 0
        r = self._lib.krun_map_se_batch(
            self._h,
            codes_flat.ctypes.data_as(_u8p), coff.ctypes.data_as(_i64p),
            hdr_flat.ctypes.data_as(_u8p), hoff.ctypes.data_as(_i64p),
            ords.ctypes.data_as(_i64p), n)
        if r < 0:
            raise RuntimeError("krun_map_se_batch failed")
        return int(r)

    def map_pe_batch(self, a_flat, a_off, ha_flat, ha_off, b_flat, b_off,
                     hb_flat, hb_off, b_present, ords, pm: int,
                     fpm: int, voffs=None) -> int:
        n = len(a_off) - 1
        if n <= 0:
            return 0
        if voffs is not None:
            va_f, va_r, vb_f, vb_r, stride = voffs
            vp = (va_f.ctypes.data_as(_i64p), va_r.ctypes.data_as(_i64p),
                  vb_f.ctypes.data_as(_i64p), vb_r.ctypes.data_as(_i64p),
                  stride)
        else:
            vp = (None, None, None, None, 0)
        r = self._lib.krun_map_pe_batch(
            self._h,
            a_flat.ctypes.data_as(_u8p), a_off.ctypes.data_as(_i64p),
            ha_flat.ctypes.data_as(_u8p), ha_off.ctypes.data_as(_i64p),
            b_flat.ctypes.data_as(_u8p), b_off.ctypes.data_as(_i64p),
            hb_flat.ctypes.data_as(_u8p), hb_off.ctypes.data_as(_i64p),
            b_present.ctypes.data_as(_u8p), ords.ctypes.data_as(_i64p),
            n, pm, fpm, *vp)
        if r < 0:
            raise RuntimeError("krun_map_pe_batch failed")
        return int(r)

    def scores(self):
        a = np.zeros(self.db_size, np.int64)
        u = np.zeros(self.db_size, np.int64)
        self._lib.krun_scores(self._h, a.ctypes.data_as(_i64p),
                              u.ctypes.data_as(_i64p))
        return a, u

    def conclave(self, version: int, lc: bool, template_tot_ulen: int,
                 scoreT: float, evalue: float, cmp_mode: str,
                 max_frag: int = 1000000):
        w = np.zeros(self.db_size, np.int64)
        fc = np.zeros(self.db_size, np.int64)
        rc = np.zeros(self.db_size, np.int64)
        cmpm = {"or": 0, "and": 1, "true": 2}[cmp_mode]
        self._lib.krun_conclave(
            self._h, version, 1 if lc else 0,
            w.ctypes.data_as(_i64p), fc.ctypes.data_as(_i64p),
            rc.ctypes.data_as(_i64p), template_tot_ulen, scoreT, evalue,
            cmpm, max_frag)
        return w, fc, rc

    def frag_count(self, t: int) -> int:
        meta = np.zeros(3, np.int64)
        self._lib.krun_stage_meta(self._h, t,
                                  meta[0:].ctypes.data_as(_i64p),
                                  meta[1:].ctypes.data_as(_i64p),
                                  meta[2:].ctypes.data_as(_i64p))
        return int(meta[0])

    def assemble_template(self, t: int, cfg, Wl_raw: int, matrix,
                          t_len: int, name: bytes, dev_pileup=None):
        """Fused stage + native assembly frag loop (assemble_KMA,
        assembly.c:1689-2127) + .frag.gz row formatting; grows and
        updates `matrix` in place; returns (score, frag_aln, read_aln,
        rows_bytes).

        ``dev_pileup(t_flat, q_flat, offs, starts, t_len) -> delta``
        puts the DENSE matrix scatter on the device: the native frag
        loop exports accepted rows instead of scattering them
        (kassem_set_pileup_export), the callable runs the device-side
        pileup, and the delta merges into the matrix here.  Overflow
        rows are host-scattered by the native loop, so the result is
        complete either way."""
        meta = np.empty(3, np.int64)
        self._lib.krun_stage_meta(self._h, t,
                                  meta[0:].ctypes.data_as(_i64p),
                                  meta[1:].ctypes.data_as(_i64p),
                                  meta[2:].ctypes.data_as(_i64p))
        n, cb, hb = int(meta[0]), int(meta[1]), int(meta[2])
        matrix.ensure(matrix.len + cb + 1)
        cap = cb + hb + n * (80 + len(name)) + 64
        rows = np.empty(cap, np.uint8)
        out = np.empty(4, np.int64)
        nm = np.frombuffer(name, np.uint8)
        from .pipeline import _pileup_floor
        if dev_pileup is not None and cfg.dense \
                and cb >= _pileup_floor(cfg):
            pcap = 2 * cb + t_len + 4096
            p_t = np.empty(pcap, np.uint8)
            p_q = np.empty(pcap, np.uint8)
            p_off = np.zeros(n + 1, np.int64)
            p_start = np.zeros(max(n, 1), np.int32)
        else:
            dev_pileup = None
        while True:
            if dev_pileup is not None:
                self._lib.kassem_set_pileup_export(
                    p_t.ctypes.data_as(_u8p), p_q.ctypes.data_as(_u8p),
                    p_off.ctypes.data_as(_i64p),
                    p_start.ctypes.data_as(_i32p), pcap, n)
            new_len = self._lib.krun_assemble_template(
                self._h, t, Wl_raw, cfg.min_len, cfg.mq, cfg.score_t,
                cfg.mrc, 1 if cfg.circular else 0, cfg.ts,
                1 if cfg.skip_tail_aln else 0, 1 if cfg.dense else 0,
                matrix.counts.ctypes.data_as(_i64p),
                matrix.next.ctypes.data_as(_i64p),
                matrix.len, t_len, nm.ctypes.data_as(_u8p), len(nm),
                out[0:].ctypes.data_as(_i64p),
                out[1:].ctypes.data_as(_i64p),
                out[2:].ctypes.data_as(_i64p),
                rows.ctypes.data_as(_u8p), cap,
                out[3:].ctypes.data_as(_i64p))
            if new_len >= 0:
                break
            cap *= 4
            rows = np.empty(cap, np.uint8)
        matrix.len = int(new_len)
        if dev_pileup is not None:
            pr = np.zeros(2, np.int64)
            pover = ctypes.c_int(0)
            self._lib.kassem_pileup_export_take(
                pr[0:].ctypes.data_as(_i64p),
                pr[1:].ctypes.data_as(_i64p), ctypes.byref(pover))
            n_rows = int(pr[0])
            if n_rows:
                delta = dev_pileup(p_t[: int(pr[1])], p_q[: int(pr[1])],
                                   p_off[: n_rows + 1],
                                   p_start[: n_rows], t_len)
                np.minimum(matrix.counts[:t_len] + delta, 0xFFFF,
                           out=matrix.counts[:t_len])
        return (int(out[0]), int(out[1]), int(out[2]),
                rows[: int(out[3])].tobytes())

    def output_all(self, w_scores: np.ndarray, names: list, cfg, Wl_raw,
                   template_tot_ulen: int, Nhits: int, bcd: int,
                   base_caller: int, significant: int, cmp_mode: int,
                   want_fsa: bool, want_aln: bool, want_frag: bool,
                   want_matrix: bool = False, vcf_filt: int = 0,
                   want_ef: bool = False, fragment_counts=None,
                   read_counts=None, t_stride=(1, 0),
                   want_segments: bool = False):
        """Native output stage fast path (runkma.c:763-863): assembles
        every passing template and formats .res/.fsa/.aln/.frag rows —
        plus optional .mat.gz/.vcf.gz/.mapstat rows (assembly.c:85,
        vcf.c:97, ef.c:48-136) — in one call; returns the seven byte
        buffers.  ``names`` is indexed by template id (entry 0 is an
        unused placeholder)."""
        names_flat = b"".join(names)
        names_off = np.zeros(len(names) + 1, np.int64)
        np.cumsum([len(n) for n in names], out=names_off[1:])
        nf = np.frombuffer(names_flat, np.uint8) if names_flat \
            else np.zeros(1, np.uint8)
        lens = np.zeros(7, np.int64)
        ws = np.ascontiguousarray(w_scores, np.int64)
        fc = np.ascontiguousarray(
            fragment_counts if fragment_counts is not None
            else np.zeros(len(names), np.int64), np.int64)
        rc = np.ascontiguousarray(
            read_counts if read_counts is not None
            else np.zeros(len(names), np.int64), np.int64)
        r = self._lib.krun_output_all(
            self._h, ws.ctypes.data_as(_i64p), nf.ctypes.data_as(_u8p),
            names_off.ctypes.data_as(_i64p), len(names),
            template_tot_ulen, Nhits, cfg.evalue, cfg.score_t,
            cmp_mode, cfg.ID_t, cfg.Depth_t, bcd, cfg.support_static,
            base_caller, significant, cfg.ref_fsa,
            1 if want_fsa else 0, 1 if want_aln else 0,
            1 if want_frag else 0,
            1 if want_matrix else 0, int(vcf_filt), 1 if want_ef else 0,
            fc.ctypes.data_as(_i64p), rc.ctypes.data_as(_i64p),
            int(t_stride[0]), int(t_stride[1]),
            Wl_raw, cfg.min_len, cfg.mq,
            cfg.score_t, cfg.mrc, 1 if cfg.circular else 0, cfg.ts,
            1 if cfg.skip_tail_aln else 0, 1 if cfg.dense else 0,
            lens[0:].ctypes.data_as(_i64p), lens[1:].ctypes.data_as(_i64p),
            lens[2:].ctypes.data_as(_i64p), lens[3:].ctypes.data_as(_i64p),
            lens[4:].ctypes.data_as(_i64p), lens[5:].ctypes.data_as(_i64p),
            lens[6:].ctypes.data_as(_i64p))
        if r < 0:
            raise RuntimeError("krun_output_all failed")
        segs = None
        if want_segments:
            ns = int(self._lib.krun_output_nseg(self._h))
            seg_tpl = np.zeros(max(ns, 1), np.int32)
            seg_lens = np.zeros(max(ns, 1) * 7, np.int64)
            self._lib.krun_output_segments(
                self._h, seg_tpl.ctypes.data_as(_i32p),
                seg_lens.ctypes.data_as(_i64p))
            segs = (seg_tpl[:ns], seg_lens[: ns * 7].reshape(ns, 7))
        bufs = [np.empty(max(1, int(n)), np.uint8) for n in lens]
        self._lib.krun_output_fetch(
            self._h, *(b.ctypes.data_as(_u8p) for b in bufs))
        out = tuple(bufs[i][: int(lens[i])].tobytes() for i in range(7))
        return (out + (segs,)) if want_segments else out

    def stage_template(self, t: int):
        """Per-template fragment stage for assembly: (q_len, best_hits,
        score, qbounds, fstats, flag, codes_flat, codes_off, hdr_flat,
        hdr_off) in printFrags (LIFO) order; None when no frags."""
        meta = np.zeros(3, np.int64)
        self._lib.krun_stage_meta(self._h, t,
                                  meta[0:].ctypes.data_as(_i64p),
                                  meta[1:].ctypes.data_as(_i64p),
                                  meta[2:].ctypes.data_as(_i64p))
        n, cb, hb = int(meta[0]), int(meta[1]), int(meta[2])
        if n == 0:
            return None
        q_len = np.zeros(n, np.int32)
        best_hits = np.zeros(n, np.int32)
        score = np.zeros(n, np.int64)
        qb = np.zeros(2 * n, np.int32)
        fs = np.zeros(3 * n, np.int32)
        flag = np.zeros(n, np.int32)
        codes = np.zeros(cb, np.uint8)
        coff = np.zeros(n + 1, np.int64)
        hdr = np.zeros(hb, np.uint8)
        hoff = np.zeros(n + 1, np.int64)
        self._lib.krun_stage_fill(
            self._h, t, q_len.ctypes.data_as(_i32p),
            best_hits.ctypes.data_as(_i32p), score.ctypes.data_as(_i64p),
            qb.ctypes.data_as(_i32p), fs.ctypes.data_as(_i32p),
            flag.ctypes.data_as(_i32p), codes.ctypes.data_as(_u8p),
            coff.ctypes.data_as(_i64p), hdr.ctypes.data_as(_u8p),
            hoff.ctypes.data_as(_i64p))
        return (q_len, best_hits, score, qb, fs, flag, codes, coff, hdr,
                hoff)

    def template_handle(self, t: int) -> int:
        return self._lib.krun_template_handle(self._h, t)

    def spool_len(self) -> int:
        return int(self._lib.krun_spool_len(self._h))

    def spool_export(self):
        """Raw spool arrays (collect mode / .frag_raw.gz): (q_len,
        best_hits, score, flag, ord, tpl, starts, ends, t_off, cod,
        cod_off, hdr, hdr_off, mcod, mcod_off, mhdr, mhdr_off, mflag)."""
        meta = np.zeros(6, np.int64)
        self._lib.krun_spool_meta(self._h,
                                  meta[0:].ctypes.data_as(_i64p),
                                  meta[1:].ctypes.data_as(_i64p),
                                  meta[2:].ctypes.data_as(_i64p),
                                  meta[3:].ctypes.data_as(_i64p),
                                  meta[4:].ctypes.data_as(_i64p),
                                  meta[5:].ctypes.data_as(_i64p))
        n, tt, cb, hb, mcb, mhb = (int(x) for x in meta)
        q_len = np.zeros(n, np.int32)
        best_hits = np.zeros(n, np.int32)
        score = np.zeros(n, np.int64)
        flag = np.zeros(n, np.int32)
        ordv = np.zeros(n, np.int64)
        tpl = np.zeros(tt, np.int32)
        starts = np.zeros(tt, np.int32)
        ends = np.zeros(tt, np.int32)
        t_off = np.zeros(n + 1, np.int64)
        cod = np.zeros(cb, np.uint8)
        cod_off = np.zeros(n + 1, np.int64)
        hdr = np.zeros(hb, np.uint8)
        hdr_off = np.zeros(n + 1, np.int64)
        mcod = np.zeros(mcb, np.uint8)
        mcod_off = np.zeros(n + 1, np.int64)
        mhdr = np.zeros(mhb, np.uint8)
        mhdr_off = np.zeros(n + 1, np.int64)
        mflag = np.zeros(n, np.int32)
        self._lib.krun_spool_fill(
            self._h, q_len.ctypes.data_as(_i32p),
            best_hits.ctypes.data_as(_i32p), score.ctypes.data_as(_i64p),
            flag.ctypes.data_as(_i32p), ordv.ctypes.data_as(_i64p),
            tpl.ctypes.data_as(_i32p), starts.ctypes.data_as(_i32p),
            ends.ctypes.data_as(_i32p), t_off.ctypes.data_as(_i64p),
            cod.ctypes.data_as(_u8p), cod_off.ctypes.data_as(_i64p),
            hdr.ctypes.data_as(_u8p), hdr_off.ctypes.data_as(_i64p),
            mcod.ctypes.data_as(_u8p), mcod_off.ctypes.data_as(_i64p),
            mhdr.ctypes.data_as(_u8p), mhdr_off.ctypes.data_as(_i64p),
            mflag.ctypes.data_as(_i32p))
        return (q_len, best_hits, score, flag, ordv, tpl, starts, ends,
                t_off, cod, cod_off, hdr, hdr_off, mcod, mcod_off, mhdr,
                mhdr_off, mflag)

    def spool_import(self, arrs):
        """Replace the driver's spool with merged flat arrays (the
        spool_export layout) — the multi-host rank-0 reduce."""
        n = len(arrs[0])
        # keep 1-element placeholders alive for empty slices
        arrs = [np.ascontiguousarray(a) if len(a)
                else np.zeros(1, np.asarray(a).dtype) for a in arrs]
        (q_len, best_hits, score, flag, ordv, tpl, starts, ends, t_off,
         cod, cod_off, hdr, hdr_off, mcod, mcod_off, mhdr, mhdr_off,
         mflag) = arrs

        def _p(a, t):
            return a.ctypes.data_as(t)
        self._lib.krun_spool_import(
            self._h, n, _p(q_len, _i32p), _p(best_hits, _i32p),
            _p(score, _i64p), _p(flag, _i32p), _p(ordv, _i64p),
            _p(tpl, _i32p), _p(starts, _i32p), _p(ends, _i32p),
            t_off.ctypes.data_as(_i64p), _p(cod, _u8p),
            cod_off.ctypes.data_as(_i64p), _p(hdr, _u8p),
            hdr_off.ctypes.data_as(_i64p), _p(mcod, _u8p),
            mcod_off.ctypes.data_as(_i64p), _p(mhdr, _u8p),
            mhdr_off.ctypes.data_as(_i64p), _p(mflag, _i32p))

    def scores_set(self, alignment_scores, uniq_alignment_scores):
        a = np.ascontiguousarray(alignment_scores, np.int64)
        u = np.ascontiguousarray(uniq_alignment_scores, np.int64)
        self._lib.krun_scores_set(self._h, a.ctypes.data_as(_i64p),
                                  u.ctypes.data_as(_i64p))


def set_circular(lib, on: bool) -> None:
    """-ca: switch the batched scorers' chainSeeds variant
    (kaln_set_circular; chainSeedsPtr role, kma.c:693)."""
    try:
        lib.kaln_set_circular(1 if on else 0)
    except AttributeError:
        pass


def make_run_driver(idx: KmaIndex, pen: Penalties,
                    template_lengths: np.ndarray, seq_path: str,
                    cfg: MapConfig, mode: int, aln_min_frac: float,
                    contamination: Optional[int]
                    ) -> Optional[RunDriver]:
    """RunDriver when the fused native path applies, else None (same DB
    eligibility gates as mapping.native_chain.make_native_chain)."""
    if idx.values is None or idx.values.dtype.itemsize not in (2, 4):
        return None
    if idx.exist is None or idx.exist.dtype.itemsize not in (4, 8):
        return None
    if not idx.mega:
        if idx.key_index is None or idx.value_index is None:
            return None
        if idx.key_index.dtype.itemsize not in (4, 8) \
                or idx.value_index.dtype.itemsize not in (4, 8):
            return None
    lib = get_lib()
    if lib is None:
        return None
    try:
        return RunDriver(lib, idx, pen, template_lengths, seq_path, cfg,
                         mode, aln_min_frac, contamination)
    except OSError:
        return None

"""Multi-host mapping runtime: jax.distributed over the 'data' axis.

Replaces the reference's single-host pthread fan-out (kmers.c:186-230,
runkma.c:293-360) with a process-per-host SPMD layout:

- every process runs the FULL local pipeline (device scan -> native
  alignment -> spool records) over its round-robin shard of the reads
  (run_kma(shard=(pid, n), collect=True)),
- `alignment_scores` / `uniq_alignment_scores` are summed across
  processes (the ConClave inputs are additive, updatescores.c:217-281)
  via a jax.distributed all-gather,
- spool records are gathered to every process and merge-sorted by their
  GLOBAL read ordinal, restoring the reference's input-stream ConClave
  order exactly (the spltDB reducer merge, spltdb.c:625-1290, lifted to
  hosts), after which rank 0 runs ConClave + assembly + output.

Outputs are therefore bit-identical for ANY process count -- asserted by
tests/test_multihost.py.
"""

from __future__ import annotations

import pickle
import sys
from typing import List, Optional

import numpy as np


def _allgather_blob(blob: bytes) -> List[bytes]:
    """All-gather one ragged byte blob per process."""
    import jax
    from jax.experimental import multihost_utils as mh

    n = np.frombuffer(blob, dtype=np.uint8)
    sizes = mh.process_allgather(np.array([len(n)], np.int64))
    cap = int(sizes.max())
    padded = np.zeros(cap, np.uint8)
    padded[: len(n)] = n
    gathered = mh.process_allgather(padded)
    return [gathered[p, : int(sizes[p, 0])].tobytes()
            for p in range(gathered.shape[0])]


def _allgather_arr(a: np.ndarray) -> List[np.ndarray]:
    """All-gather one ragged 1-D array per process (padded to max).

    Gathers raw bytes: jax.numpy would silently downcast int64 payloads
    without the x64 flag, so the dtype is re-applied after the gather."""
    from jax.experimental import multihost_utils as mh

    dt = np.asarray(a).dtype
    raw = np.ascontiguousarray(a).view(np.uint8).ravel()
    sizes = mh.process_allgather(np.array([len(raw)], np.int64))
    cap = max(int(sizes.max()), 1)
    padded = np.zeros(cap, np.uint8)
    padded[: len(raw)] = raw
    g = mh.process_allgather(padded)
    return [np.ascontiguousarray(g[p, : int(sizes[p, 0])]).view(dt)
            for p in range(g.shape[0])]


def _allgather_multi(arrays: List[np.ndarray]) -> List[List[np.ndarray]]:
    """All-gather a LIST of ragged 1-D arrays in ONE collective pair
    (sizes + payload) instead of one pair per array -- the per-collective
    barrier latency dominates for the spool's 18 small streams.

    Returns out[i][p] = array i from process p."""
    from jax.experimental import multihost_utils as mh

    dts = [np.asarray(a).dtype for a in arrays]
    raws = [np.ascontiguousarray(a).view(np.uint8).ravel()
            for a in arrays]
    sizes = mh.process_allgather(
        np.asarray([len(r) for r in raws], np.int64))
    sizes = np.atleast_2d(sizes)
    per_proc = sizes.sum(axis=1)
    cap = max(int(per_proc.max()), 1)
    padded = np.zeros(cap, np.uint8)
    off = 0
    for r in raws:
        padded[off: off + len(r)] = r
        off += len(r)
    g = mh.process_allgather(padded)
    g = np.atleast_2d(g)
    out: List[List[np.ndarray]] = [[] for _ in arrays]
    for p in range(g.shape[0]):
        off = 0
        for i, dt in enumerate(dts):
            n = int(sizes[p, i])
            out[i].append(np.ascontiguousarray(
                g[p, off: off + n]).view(dt))
            off += n
    return out


def _exchange_blobs_to_rank0(blob: bytes, prefix: str, pid: int,
                             nproc: int) -> Optional[List[bytes]]:
    """Move each rank's output blob to rank 0.

    Prefers the shared filesystem -- the reference's own spltDB
    transport (mappers write ``out.i`` files the reducer polls,
    kma.c:1387, spltdb.c:610-620) -- so the payload is never broadcast
    to every rank; falls back to the all-gather when the ranks do not
    share a filesystem.  Returns the rank-ordered blob list on rank 0,
    None elsewhere."""
    import os

    from jax.experimental import multihost_utils as mh

    path = "%s.mh%d.part" % (prefix, pid)
    ok = 1
    if pid != 0:
        try:
            with open(path + ".tmp", "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(path + ".tmp", path)
        except OSError:
            ok = 0
    flags = np.atleast_2d(mh.process_allgather(
        np.asarray([ok], np.int64)))
    if int(flags.sum()) == nproc:
        read_ok = 1
        blobs: Optional[List[bytes]] = None
        if pid == 0:
            blobs = [blob]
            for p in range(1, nproc):
                try:
                    with open("%s.mh%d.part" % (prefix, p), "rb") as f:
                        blobs.append(f.read())
                except OSError:
                    read_ok = 0
                    blobs = None
                    break
        g = np.atleast_2d(mh.process_allgather(
            np.asarray([read_ok], np.int64)))
        if pid != 0:
            try:
                os.unlink(path)
            except OSError:
                pass
        if int(g[0, 0]):
            return blobs
    # no shared filesystem: broadcast everything to everyone
    all_blobs = _allgather_blob(blob)
    return all_blobs if pid == 0 else None


def _merge_ragged(flats: List[np.ndarray], offs: List[np.ndarray],
                  order: np.ndarray):
    """Merge per-process (flat, offsets) ragged arrays into one flat
    array whose records follow ``order`` over the concatenated records."""
    lens = np.concatenate([np.diff(o) for o in offs])
    bases = np.cumsum([0] + [len(f) for f in flats[:-1]])
    starts = np.concatenate([np.asarray(o[:-1], np.int64) + b
                             for o, b in zip(offs, bases)])
    flat = np.concatenate(flats) if sum(len(f) for f in flats) \
        else np.zeros(0, flats[0].dtype)
    l2 = np.ascontiguousarray(lens[order], np.int64)
    s2 = np.ascontiguousarray(starts[order], np.int64)
    total = int(l2.sum())
    noff = np.zeros(len(order) + 1, np.int64)
    np.cumsum(l2, out=noff[1:])
    if not total:
        return np.zeros(0, flat.dtype), noff
    from ..run_native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        es = flat.dtype.itemsize
        out = np.empty(total, flat.dtype)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.POINTER(ctypes.c_longlong)
        flat = np.ascontiguousarray(flat)
        lib.krun_ragged_gather(
            flat.view(np.uint8).ctypes.data_as(u8),
            (s2 * es).ctypes.data_as(i64),
            (l2 * es).ctypes.data_as(i64), len(order),
            out.view(np.uint8).ctypes.data_as(u8))
        return out, noff
    base = np.repeat(s2, l2)
    rel = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(l2) - l2, l2)
    return np.ascontiguousarray(flat[base + rel]), noff


def _local_card(process_id: int) -> Optional[List[int]]:
    """The one GPU this process may use: several -mh processes on one
    machine must not each claim every card (a JAX process reserves most
    of a card's memory).  Process pid takes card pid modulo the cards the
    machine has; None (all visible devices) on the CPU backend or when
    CUDA_VISIBLE_DEVICES already chose."""
    import os
    if os.environ.get("CUDA_VISIBLE_DEVICES") is not None \
            or os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        return None
    try:
        n_cards = len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        import subprocess
        try:
            n_cards = len(subprocess.run(
                ["nvidia-smi", "--list-gpus"], capture_output=True,
                text=True, timeout=30).stdout.split("\n")) - 1
        except (OSError, subprocess.SubprocessError):
            return None
    return [process_id % n_cards] if n_cards > 0 else None


def run_kma_multihost(db_prefix: str, output_prefix: str,
                      input_files: List[str], cfg, exe_cmd: str,
                      coordinator: str, num_processes: int,
                      process_id: int,
                      pe_files: Optional[List[str]] = None,
                      int_files: Optional[List[str]] = None) -> int:
    import jax
    from jax.experimental import multihost_utils as mh

    from ..pipeline import _conclave_and_output, _sam_init_single, run_kma

    import time as _time
    _ti = _time.time()
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=_local_card(process_id))
    _tm = _time.time()

    # local shard: scan + align my fragments
    part = run_kma(db_prefix, output_prefix, input_files, cfg,
                   exe_cmd=exe_cmd, pe_files=pe_files,
                   int_files=int_files,
                   shard=(process_id, num_processes), collect=True)
    print("# multihost: init %.2f s, local map %.2f s"
          % (_tm - _ti, _time.time() - _tm), file=sys.stderr)

    # global ConClave inputs: element-wise sums over the data axis
    g = mh.process_allgather(np.asarray(part["alignment_scores"]))
    alignment_scores = g.sum(axis=0)
    g = mh.process_allgather(np.asarray(part["uniq_alignment_scores"]))
    uniq_alignment_scores = g.sum(axis=0)
    # every rank counts the GLOBAL fragment stream while sharding
    # ownership (pipeline._shard_reads ordinals), so the totals agree
    tot_frags = int(part["tot_frags"])
    fc = part.get("file_frag_counts")
    if fc is not None and part.get("ndrv") is not None:
        # file-sharded parse: each rank read only its own input files
        # and fed (file_idx << 40 | i) ordinals; one tiny all-gather of
        # the per-file survivor counts rebases them to the global
        # input-stream order before the reducer merge
        g = np.atleast_2d(mh.process_allgather(np.asarray(fc, np.int64)))
        counts = g.sum(axis=0)
        bases = np.concatenate(([0], np.cumsum(counts[:-1])))
        tot_frags = int(counts.sum())
        sp = list(part["spool"])
        enc = np.asarray(sp[4], np.int64)
        sp[4] = bases[enc >> np.int64(40)] \
            + (enc & ((np.int64(1) << np.int64(40)) - 1))
        part["spool"] = tuple(sp)

    names = part["names"]
    if part.get("ndrv") is not None:
        # fast path: the per-rank spools are flat native arrays — gather
        # them, merge by global read ordinal, and import the merged spool
        # into rank 0's native driver for native ConClave + output
        # (the spltdb.c:625 reducer merge over DCN, no Python records)
        import time as _time
        sp = part["spool"]
        _tg = _time.time()
        gathered = _allgather_multi(list(sp))
        _tg = _time.time() - _tg
        n_local = len(sp[0])
        n_total = sum(len(g) for g in gathered[0])
        print("# multihost: %d processes, %d local / %d total spool "
              "records (gather %.2f s)"
              % (num_processes, n_local, n_total, _tg), file=sys.stderr)
        # EVERY rank merges the identical global spool: ConClave is then
        # replicated (deterministic) so each rank can emit its 1/N slice
        # of the per-template output stage below
        _t0 = _time.time()
        ordv = np.concatenate(gathered[4])
        order = np.argsort(ordv, kind="stable")

        def cat(i):
            return np.concatenate(gathered[i])[order]

        q_len, best_hits, score, flag = (cat(0), cat(1), cat(2), cat(3))
        mflag = cat(17)
        tpl, t_off = _merge_ragged(gathered[5], gathered[8], order)
        starts, _ = _merge_ragged(gathered[6], gathered[8], order)
        ends, _ = _merge_ragged(gathered[7], gathered[8], order)
        cod, cod_off = _merge_ragged(gathered[9], gathered[10], order)
        hdr, hdr_off = _merge_ragged(gathered[11], gathered[12], order)
        mcod, mcod_off = _merge_ragged(gathered[13], gathered[14], order)
        mhdr, mhdr_off = _merge_ragged(gathered[15], gathered[16], order)
        ndrv = part["ndrv"]
        ndrv.spool_import((q_len, best_hits, score, flag, ordv[order],
                           tpl, starts, ends, t_off, cod, cod_off, hdr,
                           hdr_off, mcod, mcod_off, mhdr, mhdr_off,
                           mflag))
        ndrv.scores_set(alignment_scores, uniq_alignment_scores)
        _t1 = _time.time()

        # the per-template output stage is independent work -- distribute
        # it round-robin over the ranks (spltdb.c:1049's shard-assembly
        # role) when the native fast path applies, stitching the streams
        # back by template id on rank 0
        eligible = (not cfg.sasm and not cfg.dense and not cfg.verbose
                    and not (cfg.tsv or cfg.xml or cfg.sam)
                    and cfg.ID_t != 0.0)
        if not eligible:
            if process_id != 0:
                return 0
            rc = _conclave_and_output(
                None, part["db_size"], part["template_lengths"],
                lambda t: names[t - 1].decode("latin1"), part["store"],
                alignment_scores, uniq_alignment_scores, cfg,
                part["rew"], part["points"], part["kmersize"], db_prefix,
                output_prefix, exe_cmd, tot_frags,
                sam_init=lambda out: _sam_init_single(
                    names, part["template_lengths"], exe_cmd, out),
                ndrv=ndrv)
            _t2 = _time.time()
            print("# multihost: rank-0 merge %.2f s, conclave+output "
                  "%.2f s" % (_t1 - _t0, _t2 - _t1), file=sys.stderr)
            return rc

        import os as _os

        from ..assemble import native_assem as _na
        from ..out import writers
        from ..pipeline import CMP_CODE

        cfg_names = [b""] + list(names)
        db_size = int(part["db_size"])
        template_lengths = part["template_lengths"]
        tot_ulen = int(np.asarray(template_lengths[1:db_size]).sum())
        # replicated ConClave (deterministic on the identical merged
        # spool + summed score arrays)
        _tc0 = _time.time()
        w_scores, fragment_counts, read_counts = ndrv.conclave(
            cfg.conclave, cfg.lc, tot_ulen, cfg.score_t, cfg.evalue,
            cfg.cmp_mode, cfg.max_frag)
        _tc1 = _time.time()
        a, u = ndrv.scores()
        alignment_scores[:] = a
        uniq_alignment_scores[:] = u
        Nhits = int(np.asarray(w_scores[1:]).sum()) or 1
        rew = part["rew"]
        want_fsa = (cfg.nc & 1) == 0 or (cfg.nc & 2) == 0
        want_aln = (cfg.nc & 2) == 0
        # contiguous template ranges balanced by fragment counts (the
        # assembly cost driver), identical on every rank since the
        # conclave is replicated; stitching then reduces to a per-rank
        # byte concatenation in rank order
        wt = np.asarray(fragment_counts[:db_size], np.float64).copy()
        wt[np.asarray(w_scores[:db_size]) <= 0] = 0.0
        wt += 0.02 * (wt > 0)          # fixed per-template cost share
        cum = np.cumsum(wt)
        total_wt = float(cum[-1]) if len(cum) else 0.0
        cuts = [1]
        for r in range(1, num_processes):
            cuts.append(int(np.searchsorted(
                cum, total_wt * r / num_processes)) + 1)
        cuts.append(int(db_size))
        lo, hi = cuts[process_id], max(cuts[process_id],
                                       cuts[process_id + 1])
        seven = ndrv.output_all(
            w_scores, cfg_names, cfg, rew.Wl, tot_ulen, Nhits, cfg.bcd,
            _na.BASE_CALLERS[cfg.base_caller],
            _na.SIGNIFICANTS[cfg.significant], CMP_CODE[cfg.cmp_mode],
            want_fsa, want_aln, not cfg.nf,
            want_matrix=cfg.print_matrix, vcf_filt=cfg.vcf,
            want_ef=cfg.ef, fragment_counts=fragment_counts,
            read_counts=read_counts, t_stride=(-hi, lo))
        _tout = _time.time()
        # frag/mat/vcf go out gzipped: each rank compresses its OWN
        # section (a concatenation of gzip members is a valid gzip
        # stream), so rank 0's stitch is raw I/O instead of one serial
        # gzip pass over the whole output
        import gzip as _gzip
        seven = list(seven)
        for s in (3, 4, 5):
            if seven[s]:
                seven[s] = _gzip.compress(seven[s], 1)
        blob = pickle.dumps(tuple(seven),
                            protocol=pickle.HIGHEST_PROTOCOL)
        blobs = _exchange_blobs_to_rank0(blob, output_prefix,
                                         process_id, num_processes)
        _t2 = _time.time()
        if process_id != 0:
            return 0

        # ranges ascend with rank: template order == rank order
        parts = [pickle.loads(b) for b in blobs]
        stitched = [b"".join(p[s] for p in parts) for s in range(7)]
        res_b, fsa_b, aln_b, frag_b, mat_b, vcf_b, ef_b = stitched
        _empty = _gzip.compress(b"", 1)

        with open(output_prefix + ".res", "wb") as f:
            f.write(writers.RES_HEADER.encode("latin1"))
            f.write(res_b)
        if want_fsa:
            with open(output_prefix + ".fsa", "wb") as f:
                f.write(fsa_b)
        if want_aln:
            with open(output_prefix + ".aln", "wb") as f:
                f.write(aln_b)
        if not cfg.nf:
            with open(output_prefix + ".frag.gz", "wb") as f:
                f.write(frag_b or _empty)
        if cfg.print_matrix:
            with open(output_prefix + ".mat.gz", "wb") as f:
                f.write(mat_b or _empty)
        if cfg.vcf:
            from ..out.vcf import vcf_header
            with open(output_prefix + ".vcf.gz", "wb") as f:
                f.write(_gzip.compress(vcf_header(db_prefix), 1))
                f.write(vcf_b)
        if cfg.ef:
            with open(output_prefix + ".mapstat", "wb") as f:
                f.write(writers.mapstat_header(
                    _os.path.basename(db_prefix), tot_frags,
                    exe_cmd).encode("latin1"))
                f.write(ef_b)
        _t3 = _time.time()
        print("# multihost: rank-0 merge %.2f s, conclave+output(1/%d) "
              "%.2f s (conclave %.2f, output %.2f, bcast %.2f), "
              "stitch+write %.2f s"
              % (_t1 - _t0, num_processes, _t2 - _t1, _tc1 - _tc0,
                 _tout - _tc1, _t2 - _tout, _t3 - _t2),
              file=sys.stderr)
        return 0

    # fallback: Python records over pickle (non-fused configurations)
    blob = pickle.dumps((part["rec_ords"], part["records"]),
                        protocol=pickle.HIGHEST_PROTOCOL)
    blobs = _allgather_blob(blob)
    print("# multihost: %d processes, %d local / %d total fragments"
          % (num_processes, part["tot_frags"], tot_frags),
          file=sys.stderr)

    if process_id != 0:
        return 0

    ords: List[int] = []
    records = []
    for b in blobs:
        o, r = pickle.loads(b)
        ords.extend(o)
        records.extend(r)
    order = np.argsort(np.asarray(ords, np.int64), kind="stable")
    records = [records[i] for i in order]

    return _conclave_and_output(
        records, part["db_size"], part["template_lengths"],
        lambda t: names[t - 1].decode("latin1"), part["store"],
        alignment_scores, uniq_alignment_scores, cfg, part["rew"],
        part["points"], part["kmersize"], db_prefix, output_prefix,
        exe_cmd, tot_frags,
        sam_init=lambda out: _sam_init_single(
            names, part["template_lengths"], exe_cmd, out))

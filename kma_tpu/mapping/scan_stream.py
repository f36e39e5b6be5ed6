"""Stream reads through the device -1t1 scanner in batches.

This is the production bridge between step 1 (host read parsing /
trimming, io.pipeline.iter_reads) and step 3 (alignment): reads are
buffered into fixed-shape batches, scanned on the device with
scan_dense.DenseScanner, and re-emitted IN INPUT ORDER as the same
AnkerHit records the host SaveKmersScanner produces (savekmers.c:
2766-2833 emit rules), so the downstream ConClave spool order -- and
therefore every output file -- is byte-identical to the host path.

Overflow reads (tie lists beyond the device cap) fall back to the host
scanner read-by-read, exactly reproducing the reference semantics; the
residual is typically < 0.1% of a batch.

Reference: kmers.c:51-290 (save_kmers_batch step-2 driver).
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..config import Penalties
from ..index.format import KmaIndex
from ..io.seq import rc_codes
from .scan import AnkerHit, SaveKmersScanner


def _pad_len(n: int) -> int:
    """Bucket read lengths to limit compile-shape proliferation."""
    if n <= 128:
        return 128
    # next power-of-two-ish bucket (1.5x steps)
    b = 128
    while b < n:
        b = b * 3 // 2
        b = -(-b // 64) * 64
    return b


class DeviceScanStream:
    """Batched device scanner that yields (read, AnkerHit|None) in order.

    Parameters mirror SaveKmersScanner; `host` is the fallback scanner
    used for overflow reads (shared score arrays are safe: fallback runs
    on the host thread between device batches).
    """

    def __init__(self, idx: KmaIndex, pen: Penalties,
                 exhaustive: bool = False, proxi_frac: Optional[float] = None,
                 batch: int = 4096, host: Optional[SaveKmersScanner] = None,
                 dense=None):
        self.batches = 0   # device scan calls (diagnostics)
        if dense is not None:
            # pre-built scanner (e.g. devserve.RemoteDenseScanner): no
            # jax import / device setup in this process at all
            self.dense = dense
            self.host = host
            self.batch = batch
            self.k = idx.kmersize
            return
        from .scan_dense import DenseScanner
        try:
            self.dense = DenseScanner(idx, pen, exhaustive=exhaustive,
                                      proxi_frac=proxi_frac, batch=batch)
        except NotImplementedError:
            # big-DB path: the dense membership table exceeds the HBM
            # budget (cgMLST-class DBs); the pair-stream scanner's state
            # scales with (run, template) pairs instead of DB size
            # (kmers.c:84-125 / hashmapkma.c:264 megaMap scale story)
            from .scan_fast import FastScanner
            import sys as _sys
            print("# device scanner: dense membership over budget; "
                  "using the pair-stream scanner", file=_sys.stderr)
            self.dense = FastScanner(idx, pen, exhaustive=exhaustive,
                                     proxi_frac=proxi_frac, batch=batch)
        self.host = host
        self.batch = batch
        self.k = idx.kmersize

    def _emit(self, read, score: int, mode: int, tids: Optional[np.ndarray],
              over: bool):
        """Reconstruct the host scanner's AnkerHit (savekmers.c:2766-2833)."""
        codes = read.codes
        if over:
            if self.host is None:
                raise RuntimeError("overflow read without host fallback")
            return self.host.scan(codes, read.n_positions, read.header)
        if mode == 0:
            return None
        n_pos = read.n_positions
        if mode == 2:
            q_len = len(codes)
            n_r = (q_len - 1) - n_pos[::-1] if len(n_pos) else n_pos
            return AnkerHit(codes=rc_codes(codes),
                            n_positions=np.sort(n_r).astype(np.int32),
                            rc_flag=int(score),
                            templates=tids.astype(np.int32),
                            header=read.header, flag=16)
        return AnkerHit(codes=codes, n_positions=n_pos,
                        rc_flag=int(score), templates=tids.astype(np.int32),
                        header=read.header, flag=0)

    def stream(self, reads: Iterable) -> Iterator[Tuple[object,
                                                        Optional[AnkerHit]]]:
        """Yield (read, hit-or-None) for every read, in input order.

        Reads shorter than k bypass the device (host returns None for
        them as well, savekmers.c:2455).
        """
        buf: List = []
        for read in reads:
            buf.append(read)
            if len(buf) >= self.batch:
                yield from self._flush(buf)
                buf = []
        if buf:
            yield from self._flush(buf)

    def _flush(self, buf: List) -> Iterator[Tuple[object,
                                                  Optional[AnkerHit]]]:
        k = self.k
        scan_idx = [i for i, r in enumerate(buf) if len(r.codes) >= k]
        if not scan_idx:
            for r in buf:
                yield r, None
            return
        L = _pad_len(max(len(buf[i].codes) for i in scan_idx))
        codes = np.full((len(scan_idx), L), 4, dtype=np.uint8)
        lengths = np.zeros(len(scan_idx), np.int32)
        for j, i in enumerate(scan_idx):
            c = buf[i].codes
            codes[j, : len(c)] = c
            lengths[j] = len(c)
        res = self.dense.scan_reads(codes, lengths)
        self.batches += 1
        if isinstance(res, tuple):
            scores, modes, tid_lists, over = res
        else:  # pair-stream ScanResult (scan_fast.py)
            scores, modes, over = res.scores, res.modes, res.overflow
            tid_lists = [res.tids(i) if (modes[i] and not over[i]) else None
                         for i in range(len(scores))]
        res = {}
        for j, i in enumerate(scan_idx):
            res[i] = (int(scores[j]), int(modes[j]), tid_lists[j],
                      bool(over[j]))
        for i, r in enumerate(buf):
            if i not in res:
                yield r, None
            else:
                s, m, t, ov = res[i]
                yield r, self._emit(r, s, m, t, ov)

"""Device chain scanner: batched hash lookups on the device feeding
the native chain splicer.

The default-mode chain scan (save_kmers_chain, savekmers.c:5127-5944)
has two phases: a data-parallel per-window hash probe (the same
hashMap_getGlobal the -1t1 scanner uses) and an inherently sequential
per-read chain/splice walk over the hit stream.  Here the probe phase
runs on the device against the DenseIndex's cuckoo/mega tables -- both
strands at once, the rc side via in-register reverse-complement of the
forward k-mers -- and the resulting per-window values offsets feed the
native chainer (native/kma_chain.cpp kchain_scan_batch_dev), which
reproduces the reference chain splicing byte-exactly.

Lookup parity: the device probe returns the same value-list identity as
lookup_voff for every window (tests/test_chain_device.py), so the chain
walk sees an identical hit stream.
"""

from __future__ import annotations

import functools
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..config import Penalties
from ..index.format import KmaIndex


@functools.lru_cache(maxsize=None)
def _chain_lookup_jit():
    """Build the jitted lookup on first use: the module must import
    WITHOUT jax so devserve remote clients stay jax-free."""
    import jax
    import jax.numpy as jnp

    from .scan_dense import _lookup_rows

    @functools.partial(jax.jit, static_argnames=("k", "mega", "size",
                                                 "max_probe"))
    def _impl(exist, kv, codes, lengths, *, k, mega, size, max_probe):
        B, L = codes.shape
        W = L - k + 1
        c = jnp.where(codes == 4, 0, codes).astype(jnp.uint32)
        acc = jnp.zeros((B, W), jnp.uint32)
        for i in range(k):
            acc = (acc << 2) | jax.lax.dynamic_slice_in_dim(c, i, W,
                                                            axis=1)
        # window validity: N-free and fully inside the read
        isn = (codes == 4).astype(jnp.int32)
        pcs = jnp.pad(jnp.cumsum(isn, axis=1), ((0, 0), (1, 0)))
        nin = pcs[:, k:k + W] - pcs[:, 0:W]
        valid = (nin == 0) & (jnp.arange(W)[None, :] + k
                              <= lengths[:, None])

        args = dict(mega=mega, size=size, max_probe=max_probe)
        rows_f = jnp.where(valid, _lookup_rows((exist, kv), acc, **args),
                           np.int32(-1))
        # reverse complement of each packed k-mer (strrc in-register)
        x = ~acc
        x = ((x & np.uint32(0x33333333)) << 2) | \
            ((x >> 2) & np.uint32(0x33333333))
        x = ((x & np.uint32(0x0F0F0F0F)) << 4) | \
            ((x >> 4) & np.uint32(0x0F0F0F0F))
        x = ((x & np.uint32(0x00FF00FF)) << 8) | \
            ((x >> 8) & np.uint32(0x00FF00FF))
        x = (x << 16) | (x >> 16)
        rc = x >> (32 - 2 * k)
        rows_rc = jnp.where(valid, _lookup_rows((exist, kv), rc, **args),
                            np.int32(-1))
        return rows_f, rows_rc

    return _impl


def _chain_lookup(exist, kv, codes, lengths, *, k, mega, size, max_probe):
    """Per-window value-list rows for both strands.

    codes [B, L] u8 (N = 4, padding = 4); returns (rows_f, rows_rc)
    [B, W] i32 with -1 for miss/invalid.  rows_rc[q] is the lookup of
    revcomp(fw_kmer[q]): the rc strand's window at rc-coordinate
    p = W_r-1-q, i.e. already in the chain walk's iteration order."""
    return _chain_lookup_jit()(exist, kv, codes, lengths, k=k, mega=mega,
                               size=size, max_probe=max_probe)


@functools.lru_cache(maxsize=None)
def _chain_lookup_rle_jit():
    """RLE-compacted variant: the dense [B, W] voff rows are mostly long
    runs of identical values (hit stretches / miss stretches).  This
    compacts each row to its (run start, run value) pairs on the device,
    so the device-to-host copy carries ~W/8 entries instead of W."""
    import jax
    import jax.numpy as jnp

    from .scan_dense import _lookup_rows

    @functools.partial(jax.jit, static_argnames=("k", "mega", "size",
                                                 "max_probe", "R"))
    def _impl(exist, kv, codes, lengths, *, k, mega, size, max_probe, R):
        B, L = codes.shape
        W = L - k + 1
        c = jnp.where(codes == 4, 0, codes).astype(jnp.uint32)
        acc = jnp.zeros((B, W), jnp.uint32)
        for i in range(k):
            acc = (acc << 2) | jax.lax.dynamic_slice_in_dim(c, i, W,
                                                            axis=1)
        isn = (codes == 4).astype(jnp.int32)
        pcs = jnp.pad(jnp.cumsum(isn, axis=1), ((0, 0), (1, 0)))
        nin = pcs[:, k:k + W] - pcs[:, 0:W]
        valid = (nin == 0) & (jnp.arange(W)[None, :] + k
                              <= lengths[:, None])
        args = dict(mega=mega, size=size, max_probe=max_probe)
        rows_f = jnp.where(valid, _lookup_rows((exist, kv), acc, **args),
                           np.int32(-1))
        x = ~acc
        x = ((x & np.uint32(0x33333333)) << 2) | \
            ((x >> 2) & np.uint32(0x33333333))
        x = ((x & np.uint32(0x0F0F0F0F)) << 4) | \
            ((x >> 4) & np.uint32(0x0F0F0F0F))
        x = ((x & np.uint32(0x00FF00FF)) << 8) | \
            ((x >> 8) & np.uint32(0x00FF00FF))
        x = (x << 16) | (x >> 16)
        rc = x >> (32 - 2 * k)
        rows_rc = jnp.where(valid, _lookup_rows((exist, kv), rc, **args),
                            np.int32(-1))

        bidx = jnp.arange(B)[:, None]
        wpos = jnp.arange(W, dtype=jnp.int32)[None, :]
        assert W < (1 << 15)   # int16 run starts

        def rle(rows):
            change = jnp.concatenate(
                [jnp.ones((B, 1), bool), rows[:, 1:] != rows[:, :-1]],
                axis=1)
            rid = jnp.cumsum(change.astype(jnp.int32), axis=1) - 1
            nruns = rid[:, -1] + 1
            # run starts scatter into [B, R]; extra runs dump into the
            # discard slot R (callers re-derive overflowed rows exactly)
            slot = jnp.where(change & (rid < R), rid, R)
            starts = jnp.zeros((B, R + 1), jnp.int16) \
                .at[bidx, slot].set(
                    jnp.broadcast_to(wpos, (B, W)).astype(jnp.int16))
            vals = jnp.full((B, R + 1), -1, jnp.int32) \
                .at[bidx, slot].set(rows)
            return starts[:, :R], vals[:, :R], nruns

        sf, vf, nf = rle(rows_f)
        sr, vr, nr = rle(rows_rc)
        return sf, vf, nf, sr, vr, nr

    return _impl


def _rle_cap(W: int) -> int:
    """Static run cap per compile shape: ~W/12 rounded to 128s (real
    reads run ~W/20 runs; the rare overflow re-derives on the host)."""
    r = max(256, -(-W // 12))
    r = -(-r // 128) * 128
    return min(r, W)


def _expand_rle(starts, vals, nruns, W, over_rows=None):
    """Host-side dense reconstruction of one strand's RLE rows; rows
    whose run count overflowed the cap are skipped (caller fills)."""
    B, R = starts.shape
    out = np.full((B, W), -1, np.int32)
    for b in range(B):
        n = int(nruns[b])
        if n > R:
            continue
        if n <= 0:
            continue
        st = starts[b, :n].astype(np.int64) & 0x7FFF
        lens = np.diff(np.append(st, W))
        out[b] = np.repeat(vals[b, :n], lens)
    return out


def chain_lookup_dense(didx, idx, codes, lengths, *, compact_min_w=512):
    """(rows_f, rows_rc) as numpy, choosing the compact RLE transfer for
    wide windows.  Overflowed rows (run count past the static cap) are
    re-derived exactly on the host via the native window scanner with
    the device path's N/length masking applied."""
    k = int(idx.kmersize)
    B, L = codes.shape
    W = L - k + 1
    if W < compact_min_w or W >= (1 << 15):
        rows_f, rows_rc = _chain_lookup(
            didx.exist, didx.kv, codes, lengths, k=k, mega=didx.mega,
            size=didx.size, max_probe=didx.max_probe)
        return np.asarray(rows_f), np.asarray(rows_rc)
    R = _rle_cap(W)
    sf, vf, nf, sr, vr, nr = _chain_lookup_rle_jit()(
        didx.exist, didx.kv, codes, lengths, k=k, mega=didx.mega,
        size=didx.size, max_probe=didx.max_probe, R=R)
    sf, vf, nf = np.asarray(sf), np.asarray(vf), np.asarray(nf)
    sr, vr, nr = np.asarray(sr), np.asarray(vr), np.asarray(nr)
    rows_f = _expand_rle(sf, vf, nf, W)
    rows_rc = _expand_rle(sr, vr, nr, W)
    over = np.flatnonzero((nf > R) | (nr > R))
    if len(over):
        _host_rows(didx, idx, codes, lengths, over, rows_f, rows_rc)
    return rows_f, rows_rc


def _voff_to_row(didx, voffs):
    """values offset -> dense list id (didx.list_voff is sorted by
    construction, scan_dense.from_host)."""
    out = np.full(len(voffs), -1, np.int32)
    hit = voffs >= 0
    out[hit] = np.searchsorted(didx.list_voff,
                               voffs[hit]).astype(np.int32)
    return out


def _host_rows(didx, idx, codes, lengths, rows_sel, rows_f, rows_rc):
    """Exact host re-derivation of selected rows (RLE overflow path)."""
    from ..config import Penalties
    from .native_chain import engine_for
    from ..io.seq import kmer_scan
    from .scan import lookup_voff
    k = int(idx.kmersize)
    eng = engine_for(idx, Penalties())
    _, L = codes.shape
    W = L - k + 1
    comp = np.array([3, 2, 1, 0, 4, 5], np.uint8)
    for b in rows_sel:
        n = int(lengths[b])
        row = codes[b, :n]
        fold = np.where(row == 4, 0, row).astype(np.uint8)
        rcf = (3 - fold)[::-1].astype(np.uint8)
        if eng is not None:
            vfw = eng.lookup_windows(fold)
            vrc = eng.lookup_windows(rcf)
        else:
            vfw = np.array([lookup_voff(idx, int(x))
                            for x in kmer_scan(fold, k)], np.int64)
            vrc = np.array([lookup_voff(idx, int(x))
                            for x in kmer_scan(rcf, k)], np.int64)
        w = n - k + 1
        rows_f[b, :] = -1
        rows_rc[b, :] = -1
        if w <= 0:
            continue
        # device validity: windows containing N or beyond length -> -1
        isn = (row == 4)
        bad = np.convolve(isn.astype(np.int32), np.ones(k, np.int32),
                          "valid") > 0
        # device layout: rows_rc[q] = lookup(revcomp(fw_kmer[q])) =
        # rc-window (w-1-q), masked by the FW window's validity
        f = np.where(bad, -1, vfw[:w]).astype(np.int64)
        r = np.where(bad, -1, vrc[:w][::-1]).astype(np.int64)
        rows_f[b, :w] = _voff_to_row(didx, f)
        rows_rc[b, :w] = _voff_to_row(didx, r)


def _pad_len(n: int) -> int:
    if n <= 128:
        return 128
    b = 128
    while b < n:
        b = b * 3 // 2
        b = -(-b // 64) * 64
    return b


class DeviceChainStream:
    """Batched device hash probe + native chain splice, in input order.

    Yields (read, [AnkerHit, ...]) exactly like per-read
    NativeChain.scan; reads shorter than k yield [].
    """

    def __init__(self, idx: KmaIndex, pen: Penalties,
                 template_lengths: np.ndarray, nchain,
                 batch: int = 2048, lookup=None, voff_map=None):
        if idx.kmersize > 16:
            raise NotImplementedError("device chain lookup needs k <= 16")
        if lookup is not None:
            # remote probe fn (devserve daemon): no local device image
            self.didx = None
            self._lookup = lookup
            vm = np.asarray(voff_map, np.int64)
        else:
            from .scan_dense import DenseIndex
            self.didx = DenseIndex.from_host(idx)
            self._lookup = None
            vm = self.didx.list_voff.astype(np.int64)
        self.nchain = nchain
        self.idx = idx
        self.k = idx.kmersize
        self.batch = batch
        # cap the per-dispatch device footprint so Nanopore-length reads
        # simply shrink the batch instead of exhausting memory
        self.cell_budget = 8 << 20  # [B, W] elements per strand
        # list id -> values offset, -1 passthrough
        self.voff_map = np.concatenate([vm, [-1]])

    def _rows_to_voff(self, rows: np.ndarray) -> np.ndarray:
        return self.voff_map[rows]  # rows == -1 hits the sentinel slot

    def stream(self, reads: Iterable, exhaustive: bool, minlen: int,
               coverT: float, mrs: float, mrc: float,
               lc: bool) -> Iterator[Tuple[object, List]]:
        buf: List = []
        mx = 0
        pending = None  # (buf, device futures) for dispatch/compute overlap
        for read in reads:
            buf.append(read)
            mx = max(mx, len(read.codes))
            if (len(buf) >= self.batch
                    or len(buf) * _pad_len(mx) >= self.cell_budget):
                if pending is not None:
                    yield from self._finish(pending, exhaustive, minlen,
                                            coverT, mrs, mrc, lc)
                pending = (buf, self._dispatch(buf))
                buf = []
                mx = 0
        if pending is not None:
            yield from self._finish(pending, exhaustive, minlen, coverT,
                                    mrs, mrc, lc)
        if buf:
            yield from self._finish((buf, self._dispatch(buf)), exhaustive,
                                    minlen, coverT, mrs, mrc, lc)

    def _dispatch(self, buf: List):
        """Start the device lookup for a batch (async dispatch)."""
        k = self.k
        idxs = [i for i, r in enumerate(buf) if len(r.codes) >= k]
        if not idxs:
            return None
        L = _pad_len(max(len(buf[i].codes) for i in idxs))
        codes = np.full((len(idxs), L), 4, dtype=np.uint8)
        lengths = np.zeros(len(idxs), np.int32)
        for j, i in enumerate(idxs):
            c = buf[i].codes
            codes[j, : len(c)] = c
            lengths[j] = len(c)
        if self._lookup is not None:
            return (idxs,) + tuple(self._lookup(codes, lengths)) \
                + (None,)
        d = self.didx
        W = L - k + 1
        if 512 <= W < (1 << 15):
            # wide windows: RLE-compacted transfer (async dispatch);
            # expanded + overflow-patched at _finish time
            R = _rle_cap(W)
            fut = _chain_lookup_rle_jit()(
                d.exist, d.kv, codes, lengths, k=k, mega=d.mega,
                size=d.size, max_probe=d.max_probe, R=R)
            return idxs, fut, None, ("rle", codes, lengths, W, R)
        rows_f, rows_rc = _chain_lookup(
            d.exist, d.kv, codes, lengths,
            k=k, mega=d.mega, size=d.size, max_probe=d.max_probe)
        return idxs, rows_f, rows_rc, None

    def _finish(self, pending, exhaustive, minlen, coverT, mrs, mrc, lc):
        buf, disp = pending
        if disp is None:
            for r in buf:
                yield r, []
            return
        idxs, rows_f, rows_rc, rle = disp
        if rle is not None:
            _tag, codes, lengths, W, R = rle
            sf, vf, nf, sr, vr, nr = (np.asarray(x) for x in rows_f)
            rows_f = _expand_rle(sf, vf, nf, W)
            rows_rc = _expand_rle(sr, vr, nr, W)
            over = np.flatnonzero((nf > R) | (nr > R))
            if len(over):
                _host_rows(self.didx, self.idx, codes, lengths, over,
                           rows_f, rows_rc)
        voff_f = self._rows_to_voff(np.asarray(rows_f))
        voff_r = self._rows_to_voff(np.asarray(rows_rc))
        hits = self.nchain.scan_batch_dev(
            [buf[i].codes for i in idxs], [buf[i].header for i in idxs],
            voff_f, voff_r, exhaustive, minlen, coverT, mrs, mrc, lc)
        out = {i: h for i, h in zip(idxs, hits)}
        for i, r in enumerate(buf):
            yield r, out.get(i, [])

"""Device paired-end probe: batched hash lookups for both mates.

The PE scanners (get_kmers_for_pair, savekmers.c:427-688) spend their
window loop on hash probes exactly like the chain scan; here the probes
run on the device (the chain_device lookup kernel over the DenseIndex
cuckoo/mega tables, both strands per mate) and the per-window values
offsets feed the native pair combiners through
krun_map_pe_batch(va_f, va_r, vb_f, vb_r) /
kchain_pair_mate_v(voff_fw, voff_rc).

Lookup parity: voff[p] >= 0 iff window p is N-free and the hash hits --
identical to the host scan's ok[p] && lookup_voff, so the pair scoring
sees an identical hit stream (tests/test_pe_device.py).
"""

from __future__ import annotations

import numpy as np

from ..config import Penalties
from ..index.format import KmaIndex
from .chain_device import _chain_lookup, _pad_len


class DevicePELookup:
    """Per-batch mate window lookups on the device.

    block: rows per device call (batches are padded up to a multiple so
    the jit shape count stays bounded)."""

    def __init__(self, idx: KmaIndex, block: int = 4096, lookup=None,
                 voff_map=None):
        if lookup is not None:
            # remote probe fn (devserve daemon): jax-free client
            self.didx = None
            self._lookup = lookup
            self.voff_map = np.asarray(voff_map, np.int64)
        else:
            from .scan_dense import DenseIndex
            self.didx = DenseIndex.from_host(idx)
            self._lookup = None
            self.voff_map = np.asarray(self.didx.list_voff, np.int64)
        self.k = int(idx.kmersize)
        self.block = block

    def _rows_to_voff(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        out = np.full(rows.shape, -1, np.int64)
        hit = rows >= 0
        out[hit] = self.voff_map[rows[hit]]
        return out

    def voffs(self, flat: np.ndarray, off: np.ndarray):
        """(voff_fw, voff_rc, stride) for every read in the flat batch,
        both arrays in THAT STRAND'S window order (p ascending)."""
        n = len(off) - 1
        lens = np.diff(off).astype(np.int32)
        L = _pad_len(int(lens.max()) if n else self.k)
        nb = -(-max(n, 1) // self.block) * self.block
        codes = np.full((nb, L), 4, np.uint8)
        total = int(off[-1])
        if total:
            rows_i = np.repeat(np.arange(n), lens)
            cols_i = np.arange(total) - np.repeat(off[:-1], lens)
            codes[rows_i, cols_i] = flat[:total]
        lens_p = np.zeros(nb, np.int32)
        lens_p[:n] = lens
        if self._lookup is not None:
            rf, rr = self._lookup(codes, lens_p)
        else:
            d = self.didx
            rf, rr = _chain_lookup(d.exist, d.kv, codes, lens_p, k=self.k,
                                   mega=d.mega, size=d.size,
                                   max_probe=d.max_probe)
        vf = self._rows_to_voff(np.asarray(rf)[:n])
        vrc = self._rows_to_voff(np.asarray(rr)[:n])
        # rc strand window p corresponds to fw window q = W_i - 1 - p
        W = L - self.k + 1
        q = (lens[:, None] - self.k) - np.arange(W)[None, :]
        ok = q >= 0
        vr = np.where(ok,
                      np.take_along_axis(vrc, np.clip(q, 0, W - 1),
                                         axis=1), np.int64(-1))
        return (np.ascontiguousarray(vf), np.ascontiguousarray(vr), W)


def make_pe_lookup(idx: KmaIndex, block: int = 4096, client=None):
    """DevicePELookup or None when the dense index does not apply.

    client: a connected devserve.DevClient routes the probes through
    the persistent daemon instead of a per-run device image."""
    if client is not None:
        return DevicePELookup(idx, block=block,
                              lookup=client.chain_lookup,
                              voff_map=client.voff_map)
    try:
        return DevicePELookup(idx, block=block)
    except NotImplementedError:
        return None

"""Device-resident k-mer index and batched lookup.

The frozen hashmap (reference hashmapkma.c) holds the SEMANTICS
(k-mer -> deduplicated template list); the device layout is re-derived for
device gather efficiency rather than copied from the disk format:

- ``exist[dsize]``  murmur-spread open table at low load factor, slot ->
  record index or -1; re-hashing shrinks bucket groups (the disk table
  hashes by the raw k-mer low bits, which clusters biological k-mers and
  produced groups of 30+; murmur at load 1/4 bounds the probe unroll).
- ``kv[n, 2]``      records `(key, values_offset)` packed together so one
  8-byte gather serves the whole probe step.
- ``values``        the flat `[count, t1..tn]` lists exactly as on disk
  (offsets are shared with the host index, so results are interchangeable).

Lookup = gather exist + max_probe gathers of kv + one nothing-else; all
compare/select arithmetic stays in vector registers.

megaMap DBs (4^mlen slots) direct-address: exist[kmer] is the values
offset itself (hashmapkma.c:264-273).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..index.format import KmaIndex

MURMUR_SEED = np.uint32(3323198485 & 0xFFFFFFFF)
MURMUR_SEED2 = np.uint32(0x9747B28C)


def murmur32_np(x, seed=MURMUR_SEED) -> np.ndarray:
    v = ((np.asarray(x, dtype=np.uint64) ^ np.uint64(seed))
         * np.uint64(0x5BD1E995)) & np.uint64(0xFFFFFFFF)
    v = v.astype(np.uint32)
    return v ^ (v >> np.uint32(15))


def murmur32(x: jax.Array, seed=MURMUR_SEED) -> jax.Array:
    v = (x ^ np.uint32(seed)) * np.uint32(0x5BD1E995)
    return v ^ (v >> np.uint32(15))


def _cuckoo_build(keys: np.ndarray, voffs: np.ndarray, n: int,
                  max_rounds: int = 512):
    """Two-table cuckoo placement: every key lives at murmur(seed1) in
    table 0 or murmur(seed2) in table 1, so device lookup is exactly TWO
    8-byte gathers (vs. the serial max_probe walk of the open table).

    Returns (kv[2*tsize, 2], tsize) or None if the random walk fails
    (then the caller keeps the open layout).  Empty slots are (0, -1);
    hits require a non-negative offset.
    """
    tsize = 1 << 16
    while tsize * 10 < n * 13:  # >= 1.3n per side
        tsize <<= 1
    # the two murmur variants are correlated: a few key triples can
    # share both buckets, which no walk resolves -- wider tables fix it
    for grow in range(4):
        got = _cuckoo_place(keys, voffs, n, tsize << grow, max_rounds)
        if got is not None:
            return got
    return None


def _cuckoo_place(keys, voffs, n: int, tsize: int, max_rounds: int):
    mask = np.uint32(tsize - 1)
    tab_k = np.zeros(2 * tsize, dtype=np.int64)
    tab_v = np.full(2 * tsize, -1, dtype=np.int64)
    pk = keys.astype(np.int64)
    pv = voffs.astype(np.int64)
    ps = np.zeros(n, dtype=np.int8)
    for _ in range(max_rounds):
        if len(pk) == 0:
            break
        b = np.where(ps == 0,
                     murmur32_np(pk.astype(np.uint32)) & mask,
                     (murmur32_np(pk.astype(np.uint32), MURMUR_SEED2)
                      & mask) + np.uint32(tsize)).astype(np.int64)
        claim = np.full(2 * tsize, -1, dtype=np.int64)
        idxs = np.arange(len(pk))
        claim[b] = idxs
        win = claim[b] == idxs
        wb = b[win]
        old_k = tab_k[wb].copy()
        old_v = tab_v[wb].copy()
        tab_k[wb] = pk[win]
        tab_v[wb] = pv[win]
        occ = old_v != -1
        pk = np.concatenate([pk[~win], old_k[occ]])
        pv = np.concatenate([pv[~win], old_v[occ]])
        # losers flip sides (same-side losers would deadlock); evictees
        # move to their other table
        ps = np.concatenate([(1 - ps[~win]).astype(np.int8),
                             (wb[occ] < tsize).astype(np.int8)])
    if len(pk):
        return None
    kv = np.empty((2 * tsize, 2), dtype=np.int32)
    kv[:, 0] = (tab_k & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    kv[:, 1] = tab_v.astype(np.int32)
    return kv, tsize


@dataclasses.dataclass
class DeviceIndex:
    """JAX arrays of one frozen database (replicated or sharded).

    The device path targets standard DBs (mlen <= 16, sizes < 2^31):
    k-mers and offsets fit 32-bit lanes.  Wider DBs are refused (the host
    scanner serves them) until a 64-bit path lands.
    """

    kmersize: int
    mlen: int
    flag: int
    db_size: int
    mega: bool
    size: int                 # device table size (2^b) or mask+1 (megaMap)
    null_index: int
    exist: jax.Array          # int32: record index (or megaMap values offset)
    kv: jax.Array             # int32 [n_pad, 2]: (key, values offset)
    values: jax.Array         # int32 flat [v_index] (counts + ids, as disk)
    max_list: int             # max templates per k-mer (static pad bound)
    max_probe: int = 1        # largest bucket group (static probe unroll)

    @classmethod
    def from_host(cls, idx: KmaIndex, load_shift: int = 2) -> "DeviceIndex":
        if idx.mlen > 16 or idx.v_index >= 1 << 31 or idx.n >= 1 << 31:
            raise NotImplementedError(
                "device index requires mlen<=16 and 31-bit offsets")
        if idx.flag & 3:
            raise NotImplementedError(
                "cmer (-m/-hc) DBs use the host scanner")
        values = np.asarray(idx.values, dtype=np.int32)
        if idx.mega:
            offs = idx.exist[idx.exist != idx.null_index].astype(np.int64)
            max_list = int(values[offs].max()) if len(offs) else 0
            return cls(
                kmersize=idx.kmersize, mlen=idx.mlen, flag=idx.flag,
                db_size=idx.db_size, mega=True, size=idx.size,
                null_index=idx.null_index,
                exist=jnp.asarray(idx.exist.astype(np.int32)),
                kv=jnp.zeros((1, 2), jnp.int32),
                values=jnp.asarray(values),
                max_list=max_list, max_probe=1)

        keys = idx.key_index[: idx.n].astype(np.uint32)
        voffs = idx.value_index.astype(np.int64)
        max_list = int(values[voffs].max()) if idx.n else 0

        # preferred layout: two-table cuckoo -> exactly 2 probe gathers
        ck = _cuckoo_build(keys, voffs, int(idx.n)) if idx.n else None
        if ck is not None:
            kv, tsize = ck
            return cls(
                kmersize=idx.kmersize, mlen=idx.mlen, flag=idx.flag,
                db_size=idx.db_size, mega=False, size=tsize,
                null_index=-1,
                exist=jnp.zeros(1, jnp.int32),
                kv=jnp.asarray(kv),
                values=jnp.asarray(values),
                max_list=max_list, max_probe=0)

        # fallback open table: murmur spread, load <= 2^-load_shift
        dsize = 1 << 20
        while dsize < idx.n << load_shift:
            dsize <<= 1
        buckets = murmur32_np(keys) & np.uint32(dsize - 1)
        order = np.argsort(buckets, kind="stable")
        skeys = keys[order]
        svoffs = voffs[order].astype(np.int32)
        sbuckets = buckets[order].astype(np.int64)
        exist = np.full(dsize, -1, dtype=np.int32)
        firsts = np.ones(idx.n, dtype=bool)
        firsts[1:] = sbuckets[1:] != sbuckets[:-1]
        exist[sbuckets[firsts]] = np.flatnonzero(firsts)
        counts = np.diff(np.concatenate(
            [np.flatnonzero(firsts), [idx.n]]))
        max_probe = int(counts.max()) if idx.n else 1

        kv = np.empty((idx.n + max_probe, 2), dtype=np.int32)
        kv[: idx.n, 0] = skeys.view(np.int32)
        kv[: idx.n, 1] = svoffs
        # sentinel pad: must hash OUTSIDE the last group's bucket so the
        # overrun probe of the final group terminates (and can never equal
        # a query k-mer of that bucket)
        last_bucket = int(sbuckets[-1]) if idx.n else 0
        s = 0
        while int(murmur32_np(np.uint32(s)) & np.uint32(dsize - 1)) \
                == last_bucket:
            s += 1
        kv[idx.n:, 0] = np.int32(s)
        kv[idx.n:, 1] = np.int32(-1)

        return cls(
            kmersize=idx.kmersize, mlen=idx.mlen, flag=idx.flag,
            db_size=idx.db_size, mega=False, size=dsize,
            null_index=-1,
            exist=jnp.asarray(exist),
            kv=jnp.asarray(kv),
            values=jnp.asarray(values),
            max_list=max_list, max_probe=max_probe)


def lookup_voffsets(exist, kv, kmers, size: int, max_probe: int,
                    mega: bool, null_index: int):
    """values-offset per k-mer or -1 (hashMap_getGlobal semantics over the
    device layout)."""
    if mega:
        off = exist[(kmers & np.uint32(size - 1)).astype(jnp.int32)]
        return jnp.where(off == np.int32(null_index), -1, off)
    if max_probe == 0:
        # cuckoo layout: key at murmur(seed1) in half 0 or murmur(seed2)
        # in half 1; empty slots carry offset -1
        mask = np.uint32(size - 1)
        km = kmers.astype(jnp.int32)
        b1 = (murmur32(kmers) & mask).astype(jnp.int32)
        b2 = (murmur32(kmers, MURMUR_SEED2) & mask).astype(jnp.int32) \
            + np.int32(size)
        e1 = kv[b1]
        e2 = kv[b2]
        return jnp.where((e1[..., 0] == km) & (e1[..., 1] >= 0),
                         e1[..., 1],
                         jnp.where((e2[..., 0] == km) & (e2[..., 1] >= 0),
                                   e2[..., 1], np.int32(-1)))
    bucket = murmur32(kmers) & np.uint32(size - 1)
    pos0 = exist[bucket.astype(jnp.int32)]
    found_pos = jax.lax.full_like(kmers, -1, dtype=jnp.int32)
    km_i32 = kmers.astype(jnp.int32)
    done = pos0 < 0
    pos0 = jnp.where(done, 0, pos0)
    for step in range(max_probe):
        pos = pos0 + step
        key = kv[pos, 0]
        hit = ~done & (key == km_i32)
        found_pos = jnp.where(hit, pos, found_pos)
        if step + 1 < max_probe:
            same_bucket = (murmur32(key.astype(jnp.uint32))
                           & np.uint32(size - 1)) == bucket
            done = done | hit | ~same_bucket
    ok = found_pos >= 0
    return jnp.where(ok, kv[jnp.where(ok, found_pos, 0), 1], -1)


def batch_kmers(codes: jax.Array, k: int) -> jax.Array:
    """Rolling k-mers over a [B, L] batch of codes (N handled by caller
    masks); returns [B, L-k+1] uint32 (k <= 16)."""
    c = jnp.where(codes == 4, 0, codes).astype(jnp.uint32)
    L = codes.shape[-1]
    W = L - k + 1
    out = c[..., 0:W] << np.uint32(2 * (k - 1))
    for j in range(1, k):
        out = out + (c[..., j: W + j] << np.uint32(2 * (k - 1 - j)))
    return out


def valid_windows(codes: jax.Array, lengths: jax.Array, k: int,
                  starts=None) -> jax.Array:
    """[B, L-k+1] True where the window has no N and fits the read.

    `starts` (optional [B]) bounds windows from the left: rows holding a
    right-aligned read (the device-side reverse complement) pass
    starts = L - len and lengths = L."""
    isN = (codes == 4).astype(jnp.int32)
    cs = jnp.cumsum(isN, axis=-1)
    L = codes.shape[-1]
    width = L - k + 1
    n_in_window = cs[..., k - 1:] - jnp.pad(cs, ((0, 0), (1, 0)))[..., :width]
    pos = np.arange(width, dtype=np.int32)
    fits = pos[None, :] + k <= lengths[:, None]
    if starts is not None:
        fits = fits & (pos[None, :] >= starts[:, None])
    return (n_in_window == 0) & fits

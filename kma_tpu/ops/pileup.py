"""Device pileup: the assembly count-matrix scatter on the device.

The per-template pileup (alnToMatDense, assembly.c:1446-1497; SURVEY
hot loop #3) walks each accepted fragment's aligned (template, query)
byte rows and increments ``counts[pos][q]`` wherever the template byte
is not a gap, positions wrapping circularly at t_len
(assembly.c:1852-1855).  Here the walk becomes a batched scatter-add:
per-fragment positions come from a prefix-sum over the
template-advance mask, the trailing dual-gap trim is a reverse cummax,
and the whole batch lands in one ``.at[].add``.  Per-increment u16
saturation commutes with sum-then-clip for +1 updates, so the result
is exactly the reference's saturated matrix.

``pileup_dense_sharded`` shards the fragment batch over a mesh's
'data' axis and psums the partial matrices (SURVEY §7.6: threaded /
spltDB assembly count all-reduce) -- the multi-host shape, certified
on the CPU mesh by tests/test_pileup_device.py and exercised by
__graft_entry__.dryrun_multichip on the production semantics.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

USHRT_MAX = 0xFFFF

# process-wide counters (tests / diagnostics)
DELTA_STATS = {"calls": 0, "rows": 0}


@functools.partial(jax.jit, static_argnames=("t_len",))
def pileup_dense(aln_t, aln_q, lens, starts, *, t_len):
    """Delta counts [t_len, 6] i32 for a batch of aligned fragments.

    aln_t/aln_q [N, L] u8 (gap = 5, pad with 5), lens [N] i32 aligned
    lengths, starts [N] i32 template start positions.  Add into an
    existing matrix with ``minimum(existing + delta, USHRT_MAX)``.
    """
    import jax.numpy as jnp

    N, L = aln_t.shape
    col = np.arange(L, dtype=np.int32)[None, :]
    valid = col < lens[:, None]
    # trailing dual-gap trim (assembly.c:1470-1475): keep byte i iff
    # some j >= i has neither side gapped
    nongap = (aln_t != 5) & (aln_q != 5) & valid
    keep = jnp.flip(jax.lax.cummax(
        jnp.flip(nongap.astype(jnp.int32), axis=1), axis=1), axis=1) > 0
    tmove = (aln_t != 5) & valid
    csum = jnp.cumsum(tmove.astype(jnp.int32), axis=1)
    prev = jnp.concatenate(
        [jnp.zeros((N, 1), jnp.int32), csum[:, :-1]], axis=1)
    pos = (starts[:, None] + prev) % np.int32(t_len)
    upd = tmove & keep
    idx = pos * np.int32(6) + aln_q.astype(jnp.int32)
    flat = jnp.zeros(t_len * 6, jnp.int32).at[
        jnp.where(upd, idx, t_len * 6)
    ].add(jnp.where(upd, 1, 0), mode="drop")
    return jnp.minimum(flat.reshape(t_len, 6), np.int32(USHRT_MAX))


def pileup_dense_sharded(mesh, aln_t, aln_q, lens, starts, *, t_len,
                         axis="data"):
    """Fragment-sharded pileup: each mesh slice scatters its fragments,
    partial matrices psum over ``axis`` (the spltDB / threaded-assembly
    count all-reduce).  Row count must divide the axis size."""
    import jax
    from jax.sharding import PartitionSpec as P

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(axis), P(axis), P(axis), P(axis)),
                       out_specs=P())
    def _go(t, q, ln, st):
        part = pileup_dense(t, q, ln, st, t_len=t_len)
        return jax.lax.psum(part, axis)

    out = _go(aln_t, aln_q, lens, starts)
    import jax.numpy as jnp
    return jnp.minimum(out, np.int32(USHRT_MAX))


@functools.partial(jax.jit, static_argnames=("t_pad",))
def pileup_dense_tpad(aln_t, aln_q, lens, starts, t_len, *, t_pad):
    """pileup_dense with a DYNAMIC template length over a padded
    [t_pad, 6] output -- one compile per (N, L, t_pad) bucket instead of
    one per template, which is what makes the op servable from a
    persistent daemon across a whole DB."""
    import jax.numpy as jnp

    N, L = aln_t.shape
    col = np.arange(L, dtype=np.int32)[None, :]
    valid = col < lens[:, None]
    nongap = (aln_t != 5) & (aln_q != 5) & valid
    keep = jnp.flip(jax.lax.cummax(
        jnp.flip(nongap.astype(jnp.int32), axis=1), axis=1), axis=1) > 0
    tmove = (aln_t != 5) & valid
    csum = jnp.cumsum(tmove.astype(jnp.int32), axis=1)
    prev = jnp.concatenate(
        [jnp.zeros((N, 1), jnp.int32), csum[:, :-1]], axis=1)
    pos = (starts[:, None] + prev) % t_len.astype(jnp.int32)
    upd = tmove & keep
    idx = pos * np.int32(6) + aln_q.astype(jnp.int32)
    flat = jnp.zeros(t_pad * 6, jnp.int32).at[
        jnp.where(upd, idx, t_pad * 6)
    ].add(jnp.where(upd, 1, 0), mode="drop")
    return jnp.minimum(flat.reshape(t_pad, 6), np.int32(USHRT_MAX))


def _pow2_at_least(v: int, floor: int) -> int:
    p = floor
    while p < v:
        p <<= 1
    return p


def pileup_delta(aln_t_flat, aln_q_flat, offs, starts, t_len: int):
    """Host entry for the daemon's ``pileup`` op: ragged aligned rows
    (flat bytes + offsets, gap/pad code 5) -> delta matrix
    [t_len, 6] i32.  Rows are bucketed into fixed 256-row chunks with a
    power-of-two lane pad so the compile-shape set stays tiny."""
    import jax.numpy as jnp

    n = len(offs) - 1
    lens = np.diff(offs).astype(np.int32)
    t_pad = _pow2_at_least(t_len, 256)
    total = np.zeros((t_len, 6), np.int64)
    ROWS = 256
    for off in range(0, n, ROWS):
        sel = np.arange(off, min(off + ROWS, n))
        ml = int(lens[sel].max()) if len(sel) else 0
        L = _pow2_at_least(ml, 128)
        at = np.full((ROWS, L), 5, np.uint8)
        aq = np.full((ROWS, L), 5, np.uint8)
        ln = np.zeros(ROWS, np.int32)
        st = np.zeros(ROWS, np.int32)
        for j, i in enumerate(sel.tolist()):
            a, b = int(offs[i]), int(offs[i + 1])
            at[j, : b - a] = aln_t_flat[a:b]
            aq[j, : b - a] = aln_q_flat[a:b]
            ln[j] = b - a
            st[j] = starts[i]
        d = pileup_dense_tpad(jnp.asarray(at), jnp.asarray(aq),
                              jnp.asarray(ln), jnp.asarray(st),
                              jnp.asarray(np.int32(t_len)), t_pad=t_pad)
        total += np.asarray(d)[:t_len].astype(np.int64)
    return np.minimum(total, USHRT_MAX).astype(np.int64)

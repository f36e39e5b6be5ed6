"""Shared save_kmers scoring arithmetic (savekmers.c:2529-2625).

The gap/SNP/reconnect score formulas used by every device scanner
generation (dense membership scanner scan_dense.py, pair-stream big-DB
scanner scan_fast.py).  Pure functions of ScanParams -- kept separate so
the scanners share one parity-pinned implementation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class ScanParams:
    k: int
    mlen: int
    M: int
    MM: int
    U: int
    W1: int
    max_list: int
    exhaustive: bool
    max_probe: int
    run_cap: int = 64     # max value-list runs per read handled on device
    pair_cap: int = 1024  # max (run, template) pairs per read on device
    best_cap: int = 64    # max tie-list size returned per read
    small_ids: bool = False  # template ids fit int16 (halves D2H traffic)


def _gap_mm_terms(gap, k, M, MM, U, W1):
    """The kmersize<gap branch (savekmers.c:2536-2557) vectorised."""
    g = gap - (k - 1)
    small = g <= 2
    mm_big = jnp.maximum(2, g // k + jnp.where(g % k != 0, 1, 0))
    mm = jnp.where(small, g, mm_big)
    m = jnp.where(small, 0, jnp.minimum(jnp.minimum(g - mm_big, k), mm_big))
    gap_opt = W1 + (g - 1) * U
    mm_opt = mm * MM + m * M
    return jnp.where(gap_opt <= mm_opt, mm_opt, gap_opt)


def _run_transition_score(gap, p: ScanParams):
    """In-run contribution per consecutive same-list hit
    (savekmers.c:2529-2569)."""
    k, mlen = p.k, p.mlen
    M, MM, U, W1 = p.M, p.MM, p.U, p.W1
    match = gap == 0
    snp = (mlen <= gap) & (gap <= k)
    big = k < gap
    s_snp = k * M + MM
    s_big = k * M + _gap_mm_terms(gap, k, M, MM, U, W1)
    if mlen != k:
        s_small = gap * M + MM
    else:
        s_small = gap * M + W1 + (k - gap) * U
    return jnp.where(match, M,
                     jnp.where(snp, s_snp,
                               jnp.where(big, s_big, s_small)))


def _reconnect_score(gap, p: ScanParams, rc_branch):
    """Flush-time reconnect for an already-included template
    (savekmers.c:2590-2625 fw, :2901-2936 rc; the SNP case differs).
    rc_branch may be a per-row bool array (fused-strand batches)."""
    k, mlen = p.k, p.mlen
    M, MM, U, W1 = p.M, p.MM, p.U, p.W1
    match = gap == 0
    snp = (mlen <= gap) & (gap <= k)
    big = k < gap
    s_snp = jnp.where(rc_branch, k * M + MM, gap * M + MM)
    s_big = k * M + _gap_mm_terms(gap, k, M, MM, U, W1)
    if mlen != k:
        s_small = gap * M + MM
    else:
        s_small = gap * M + (k - gap) * U + W1
    return jnp.where(match, M,
                     jnp.where(snp, s_snp,
                               jnp.where(big, s_big, s_small)))


def rc_batch(codes: jax.Array, lengths: jax.Array) -> jax.Array:
    """Per-read reverse complement within the padded buffer."""
    L = codes.shape[-1]
    idx = lengths[:, None] - 1 - np.arange(L, dtype=np.int32)[None, :]
    ok = idx >= 0
    gathered = jnp.take_along_axis(codes, jnp.where(ok, idx, 0), axis=-1)
    # arithmetic complement (0<->3, 1<->2, >=4 unchanged), no table gather
    comp = jnp.where(gathered < 4, jnp.uint8(3) - gathered, gathered)
    return jnp.where(ok, comp, jnp.uint8(4))


def _segment_starts(codes: jax.Array) -> jax.Array:
    """For each window position, the start of its N-free segment."""
    L = codes.shape[-1]
    pos = np.arange(L, dtype=np.int32)[None, :]
    lastN = jax.lax.cummax(jnp.where(codes == 4, pos, -1), axis=1)
    return lastN + 1

"""Pallas (Triton) kernel: the dense -1t1 scan's run-scoring loop.

This is the hot loop of the dense scanner (savekmers.c:2573-2625 flush
logic, vectorised over templates).  Each template's state -- score,
extend position and first-inclusion run -- is independent of every
other template's and is carried through a sequential loop over the
read's runs.  The plain XLA loop (scan_dense._dense_strand_scan) writes
the three [G, t_pad] state arrays to device memory and reads them back
once per chunk of runs; this kernel gives each block a tile of GT rows
by TT templates, keeps that tile's state in registers for the whole
loop, reads each run's membership word straight from the bit table
(small enough to stay in L2 for a gene panel) and writes score and
first once.

Inputs (G strand rows, R run slots, V value lists):
  rmax   [G // GT] i32 -- live-run bound of each row tile
  run_row, rstart, rend, rscore, ract  [G, R] i32 -- per-run list id,
         start window, end window, in-run score, 1 if the slot is live
  rc     [G] i32 -- 1 for reverse-complement rows (the SNP reconnect
         term differs, savekmers.c:2901)
  bits   [V, t_pad // 32] u32 -- template t of list v is bit t % 32 of
         word t // 32 of row v
Outputs: score [G, t_pad] i32 and first [G, t_pad] i32 (run index of
first inclusion, BIG if never included), consumed by the XLA epilogue.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BIG = np.int32(0x3FFFFFFF)
GT = 16    # strand rows per block
TT = 128   # templates per block (t_pad is a multiple of 128)


def _gap_mm_terms(g_, k, M, MM, U, W1):
    """kmersize<gap branch (savekmers.c:2536-2557); g_ = gap - (k-1).
    Only lanes with g_ > 1 are selected downstream, so truncating
    division equals the reference's on every lane that counts."""
    small = g_ <= 2
    q = jax.lax.div(g_, np.int32(k))
    r = jax.lax.rem(g_, np.int32(k))
    mm_big = jnp.maximum(2, q + jnp.where(r != 0, 1, 0))
    mm = jnp.where(small, g_, mm_big)
    m = jnp.where(small, 0, jnp.minimum(jnp.minimum(g_ - mm_big, k), mm_big))
    gap_opt = W1 + (g_ - 1) * U
    mm_opt = mm * MM + m * M
    return jnp.where(gap_opt <= mm_opt, mm_opt, gap_opt)


def _reconnect(gap, rc, k, mlen, M, MM, U, W1):
    """_reconnect_score (savekmers.c:2590-2625 fw / :2901-2936 rc)."""
    match = gap == 0
    snp = (mlen <= gap) & (gap <= k)
    big = k < gap
    s_snp = jnp.where(rc != 0, k * M + MM, gap * M + MM)
    s_big = k * M + _gap_mm_terms(gap - (k - 1), k, M, MM, U, W1)
    if mlen != k:
        s_small = gap * M + MM
    else:
        s_small = gap * M + (k - gap) * U + W1
    return jnp.where(match, M,
                     jnp.where(snp, s_snp,
                               jnp.where(big, s_big, s_small)))


def _run_loop_kernel(rmax_ref, run_row_ref, rstart_ref, rend_ref,
                     rscore_ref, ract_ref, rc_ref, bits_ref, score_ref,
                     first_ref, *, k, mlen, M, MM, U, W1):
    i = pl.program_id(0)
    j = pl.program_id(1)
    rows = i * GT + jnp.arange(GT, dtype=jnp.int32)
    tpl = j * TT + jnp.arange(TT, dtype=jnp.int32)
    word = (tpl // 32)[None, :]
    shift = (tpl % 32).astype(jnp.uint32)[None, :]
    rc = rc_ref[rows][:, None]
    kM = np.int32(k * M)

    def body(r, state):
        score, ext, first = state
        memb = bits_ref[run_row_ref[rows, r][:, None], word]   # [GT, TT]
        act = (ract_ref[rows, r] != 0)[:, None]
        ism = act & (((memb >> shift) & np.uint32(1)) != 0)
        inc = first < BIG
        g = (rstart_ref[rows, r][:, None] - 1) - ext
        rec = _reconnect(g, rc, k, mlen, M, MM, U, W1)
        contrib = rscore_ref[rows, r][:, None] + jnp.where(inc, rec, kM)
        score = jnp.where(ism, score + contrib, score)
        first = jnp.where(ism & ~inc, r, first)
        ext = jnp.where(ism, rend_ref[rows, r][:, None], ext)
        return score, ext, first

    zero = jnp.zeros((GT, TT), jnp.int32)
    init = (zero, zero, jnp.full((GT, TT), BIG, jnp.int32))
    score, _, first = jax.lax.fori_loop(0, rmax_ref[i], body, init)
    score_ref[...] = score
    first_ref[...] = first


@functools.partial(jax.jit, static_argnames=("sparams", "interpret"))
def run_score_kernel(bits, run_row, rstart, rend, rscore, ract, rc_rows,
                     rmax_tile, *, sparams, interpret=False):
    """Dense per-template state loop on the GPU.

    bits [V, t_pad // 32] u32; run_row/rstart/rend/rscore/ract [G, R]
    i32; rc_rows [G] i32; rmax_tile [G // GT] i32.  G must be a multiple
    of GT and t_pad of TT.  Returns (score [G, t_pad], first [G, t_pad])
    i32.  interpret=True runs the Pallas interpreter (tests on the CPU).
    """
    k, mlen, M, MM, U, W1 = sparams
    G = run_row.shape[0]
    t_pad = bits.shape[1] * 32
    kern = functools.partial(_run_loop_kernel, k=k, mlen=mlen, M=M, MM=MM,
                             U=U, W1=W1)
    out_spec = pl.BlockSpec((GT, TT), lambda i, j: (i, j))
    return pl.pallas_call(
        kern,
        out_shape=[jax.ShapeDtypeStruct((G, t_pad), jnp.int32),
                   jax.ShapeDtypeStruct((G, t_pad), jnp.int32)],
        grid=(G // GT, t_pad // TT),
        in_specs=[pl.no_block_spec] * 8,
        out_specs=[out_spec, out_spec],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="kma_run_score",
    )(rmax_tile, run_row, rstart, rend, rscore, ract, rc_rows, bits)

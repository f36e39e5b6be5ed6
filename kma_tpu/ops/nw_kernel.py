"""Banded Needleman-Wunsch wavefront (score only), fed by codes.

The hot loop of step-3 candidate scoring (NW_band_score, nw.c:892-1188;
SURVEY hard part #1).  The reference's banded DP is sheared along the
(t_len+q_len)/2 diagonal so each row's cells live at fixed band lanes:
lane n of row m holds query position ``sq - (sn - n)`` and neighbours
reduce to same/adjacent-lane reads of the previous row.  The within-row
affine-gap recurrence (Q[n] = max(D[n+1]+W1, Q[n+1]+U), nw.c:995-1010)
is solved with a suffix max over D0[n] + n*max(W1,U): opening from a
gap-valued cell can never beat extending when W1 <= U, so the D<->Q
cycle breaks (the same reformulation as the oracle-exact host row step,
align/nw.py).

Inputs are codes, not staged scores.  The sheared geometry gives every
row the query window qpos(n) = K + n - i, so one per-alignment query
strip serves all rows:

  qext [B, R+L] u8 -- query codes over qpos = K-R+1+j (5 = out of range);
                      row i lane n reads qext[:, R-1-i+n]
  tcol [R, B] u8   -- template code of row i (template base t_len-1-i)

and the match score is DMAT[tcol][qext] with row/column 5 scoring 0.

Two implementations of one function, chosen by ops/platform.py:
``nw_band_score_plain`` (jax.numpy: a fori_loop over rows with a
reverse cummax) and a CUDA kernel (native/nw_band.cu) that runs one
warp per alignment with the band lanes in registers.  Scores are exact
against nw_band (oracle-tested vs nw.c) for the k modes the production
aligner issues (0, +-1, 2, -2) on non-circular windows.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

NEG_CAP = np.int32(-(1 << 29))

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CUDA_SRC = os.path.join(_REPO, "native", "nw_band.cu")
CUDA_LIB = os.path.join(_REPO, ".cache", "cuda", "libkma_nw_band.so")
_FFI_TARGET = "kma_nw_band"


def score_table(DMAT) -> np.ndarray:
    """Flat 6x6 i8 score table; row/column 5 = out-of-range pad, 0."""
    dm = np.zeros((6, 6), np.int8)
    for t in range(5):
        for q in range(5):
            dm[t, q] = DMAT[t][q]
    return dm.ravel()


@functools.partial(jax.jit, static_argnames=("DMAT", "W1", "U", "MM"))
def nw_band_score_plain(t_len, q_len, kflag, half_band, qext, tcol, *,
                        DMAT, W1, U, MM):
    """Batched banded-NW scores in jax.numpy (the reference twin of the
    CUDA kernel).  t_len/q_len/kflag/half_band [B] i32, qext [B, R+L]
    u8, tcol [R, B] u8; DMAT the 5x5 score matrix as a static tuple.
    Returns scores [B] i32."""
    R, B = tcol.shape
    L = qext.shape[1] - R
    dm = jnp.asarray(score_table(DMAT), jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    t_len = jnp.asarray(t_len, jnp.int32)[:, None]
    q_len = jnp.asarray(q_len, jnp.int32)[:, None]
    kflag = jnp.asarray(kflag, jnp.int32)[:, None]
    half_band = jnp.asarray(half_band, jnp.int32)[:, None]
    qext = qext.astype(jnp.int32)
    band = 2 * half_band
    bq_len = band + 1
    neg = (t_len + q_len) * np.int32(MM + U + W1)
    c_pos0 = (t_len + q_len) >> 1
    sn0 = q_len - 1 - (c_pos0 - half_band)

    # init row m == t_len (nw.c:975-995)
    Dp = jnp.where(lane < sn0, np.int32(W1) + (sn0 - lane - 1) * np.int32(U),
                   neg)
    Dp = jnp.where(lane == sn0, 0, Dp)
    Dp = jnp.where((kflag == 2) & (lane <= sn0), 0, Dp)
    Pp = jnp.where((lane == sn0) & (kflag != 2), 0, neg)
    Dp = jnp.where(lane > bq_len, NEG_CAP, Dp)
    Pp = jnp.where(lane > bq_len, NEG_CAP, Pp)

    Up = np.int32(max(W1, U))
    lane_up = lane * Up

    def body(i, carry):
        Dp, Pp, Dp2, Pp2, best, en_prev = carry
        c_pos = c_pos0 - i
        m = t_len - 1 - i
        active = m >= 0
        sq_raw = c_pos + half_band
        eq_raw = c_pos - half_band
        en = jnp.where(eq_raw < 0, en_prev + 1, 0)
        eq = jnp.maximum(eq_raw, 0)

        interior = sq_raw < (q_len - 1)
        sn_cell = en + (q_len - eq)            # edge-cell lane
        edge_val = jnp.where(kflag > 0, 0,
                             np.int32(W1) + (t_len - 1 - m) * np.int32(U))
        # boundary source one lane above the loop's top lane
        bval = jnp.where(interior, neg, edge_val)
        blane = jnp.where(interior, bq_len, sn_cell)
        top = blane - 1                        # last looped lane

        qc = jax.lax.dynamic_slice_in_dim(qext, R - 1 - i, L, axis=1)
        tc = jax.lax.dynamic_index_in_dim(tcol, i, 0, keepdims=False)
        msc = dm[tc.astype(jnp.int32)[:, None] * 6 + qc]

        inloop = (lane >= en + 1) & (lane <= top)
        P = jnp.maximum(jnp.roll(Dp, 1, axis=1) + np.int32(W1),
                        jnp.roll(Pp, 1, axis=1) + np.int32(U))
        D0 = jnp.maximum(P, Dp + msc)
        # boundary value participates in the gap scan
        D0b = jnp.where(lane == blane, bval, D0)
        D0b = jnp.where(inloop | (lane == blane), D0b, NEG_CAP)

        # exclusive suffix max of D0b[j] + j*Up over j > n
        s = jnp.where(lane <= bq_len, D0b + lane_up, NEG_CAP)
        s = jnp.concatenate([s[:, 1:], jnp.full((B, 1), NEG_CAP)], axis=1)
        s = jax.lax.cummax(s, axis=1, reverse=True)
        Q = s - (lane + 1) * Up + np.int32(W1)

        Dn = jnp.where(inloop, jnp.maximum(D0, Q), Dp)
        Pn = jnp.where(inloop, P, Pp)
        # the n == en boundary cell (nw.c:1100-1130): no P available
        at_en = lane == en
        Dn = jnp.where(at_en, jnp.maximum(Dp + msc, Q), Dn)
        Pn = jnp.where(at_en, neg, Pn)
        # the edge cell when the band hits q_len-1
        at_edge = (~interior) & (lane == sn_cell)
        Dn = jnp.where(at_edge, edge_val, Dn)
        Pn = jnp.where(at_edge, neg, Pn)
        # the reference DOUBLE-BUFFERS rows (nw.c D_ptr/D_prev swap):
        # lanes not written this row keep the value from TWO rows ago,
        # which the k == -2 final scan can observe
        written = (lane >= en) & (lane <= blane)
        Dn = jnp.where(written, Dn, Dp2)
        Pn = jnp.where(written, Pn, Pp2)

        # k < 0 interior best over rows with eq == 0 (nw.c:1134-1139)
        den = jnp.sum(jnp.where(at_en, Dn, 0), axis=1, keepdims=True)
        track = active & (eq_raw <= 0) & (kflag < 0)
        best = jnp.where(track & (best < den), den, best)

        return (jnp.where(active, Dn, Dp), jnp.where(active, Pn, Pp),
                jnp.where(active, Dp, Dp2), jnp.where(active, Pp, Pp2),
                best, jnp.where(active, en, en_prev))

    Dp, Pp, _, _, best, en_fin = jax.lax.fori_loop(
        0, R, body, (Dp, Pp, Dp, Pp, neg, jnp.zeros_like(t_len)))

    # final score (nw.c:1155-1175)
    den = jnp.sum(jnp.where(lane == en_fin, Dp, 0), axis=1, keepdims=True)
    score = jnp.where(kflag < 0, jnp.maximum(best, den), den)
    row_max = jnp.max(jnp.where((lane >= en_fin) & (lane < bq_len), Dp,
                                NEG_CAP), axis=1, keepdims=True)
    score = jnp.where(kflag == -2, jnp.maximum(score, row_max), score)
    return score[:, 0]


# -- CUDA kernel (GPU) --------------------------------------------------------

_cuda_lock = threading.Lock()
_cuda_ready = False


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the GPU NW kernel is built from "
                           "native/nw_band.cu with the CUDA toolkit")
    return nvcc


def build_cuda_lib() -> str:
    """Compile native/nw_band.cu for Hopper (sm_90a) into .cache/cuda
    when the library is missing or older than its source."""
    if (os.path.exists(CUDA_LIB)
            and os.path.getmtime(CUDA_LIB) >= os.path.getmtime(CUDA_SRC)):
        return CUDA_LIB
    os.makedirs(os.path.dirname(CUDA_LIB), exist_ok=True)
    tmp = "%s.%d.tmp" % (CUDA_LIB, os.getpid())
    subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-I", jax.ffi.include_dir(), "-o", tmp, CUDA_SRC],
        check=True, capture_output=True)
    os.replace(tmp, CUDA_LIB)
    return CUDA_LIB


def _register_cuda() -> None:
    global _cuda_ready
    with _cuda_lock:
        if _cuda_ready:
            return
        lib = ctypes.cdll.LoadLibrary(build_cuda_lib())
        jax.ffi.register_ffi_target(
            _FFI_TARGET, jax.ffi.pycapsule(lib.KmaNwBand), platform="CUDA")
        _cuda_ready = True


@functools.partial(jax.jit, static_argnames=("DMAT", "W1", "U", "MM"))
def _nw_band_score_cuda(t_len, q_len, kflag, half_band, qext, tcol, *,
                        DMAT, W1, U, MM):
    B = tcol.shape[1]
    call = jax.ffi.ffi_call(_FFI_TARGET,
                            jax.ShapeDtypeStruct((B,), jnp.int32))
    return call(jnp.asarray(t_len, jnp.int32),
                jnp.asarray(q_len, jnp.int32),
                jnp.asarray(kflag, jnp.int32),
                jnp.asarray(half_band, jnp.int32),
                jnp.asarray(qext, jnp.uint8), jnp.asarray(tcol, jnp.uint8),
                jnp.asarray(score_table(DMAT)),
                W1=np.int32(W1), U=np.int32(U), MM=np.int32(MM))


#: lane widths the CUDA kernel is instantiated for (32 lanes per warp
#: times 4 or 8 cells per thread)
CUDA_LANES = (128, 256)


def nw_band_score(t_len, q_len, kflag, half_band, qext, tcol, *, DMAT, W1,
                  U, MM):
    """Batched banded-NW scores [B] i32 on this process's platform: the
    CUDA kernel on the GPU, nw_band_score_plain on the CPU."""
    from .platform import use_kernels
    kw = dict(DMAT=DMAT, W1=int(W1), U=int(U), MM=int(MM))
    if use_kernels():
        L = qext.shape[1] - tcol.shape[0]
        if L not in CUDA_LANES:
            raise ValueError("NW lane width %d not in %s" % (L, CUDA_LANES))
        _register_cuda()
        return _nw_band_score_cuda(t_len, q_len, kflag, half_band, qext,
                                   tcol, **kw)
    return nw_band_score_plain(t_len, q_len, kflag, half_band, qext, tcol,
                               **kw)


def stage_code_inputs(templates, queries, t_lens, q_lens, band, L=None):
    """Host staging for nw_band_score (test/bench path; the production
    stager is native kaln_se_stage_codes).  Returns (t_len, q_len, hb,
    qext [B, R+L] u8, tcol [R, B] u8)."""
    B = len(templates)
    bands = np.broadcast_to(np.asarray(band, np.int32), (B,)).copy()
    bands += bands & 1
    if L is None:
        L = -(-(int(bands.max()) + 2) // 128) * 128
    R = int(max(int(t) for t in t_lens))
    qext = np.full((B, R + L), 5, np.uint8)
    tcol = np.zeros((R, B), np.uint8)
    for b in range(B):
        half = int(bands[b]) // 2
        t = np.asarray(templates[b])
        q = np.asarray(queries[b])
        t_len = int(t_lens[b])
        q_len = int(q_lens[b])
        # qpos(n) = K + n - i with K = c0 - half, EXCEPT when the band
        # is wider than the alignment (c0 < half): then en = i+1 on
        # every row and the offset saturates at -1
        K = max(((t_len + q_len) >> 1) - half, -1)
        qpos = K - R + 1 + np.arange(R + L)
        ok = (qpos >= 0) & (qpos < q_len)
        qext[b, ok] = q[qpos[ok]]
        rows = np.arange(min(t_len, R))
        tcol[rows, b] = t[t_len - 1 - rows]
    return (np.asarray(t_lens, np.int32), np.asarray(q_lens, np.int32),
            (bands // 2).astype(np.int32), qext, tcol)

"""Banded-NW scorer (ops/nw_kernel.py) vs the oracle-exact host nw_band.

On the CPU these run the plain jax.numpy implementation, which is the
GPU kernel's reference twin; chip_smoke.py compares the CUDA kernel with
it at real widths on the card."""

import numpy as np
import pytest

from kma_tpu.align.nw import nw_band
from kma_tpu.config import Penalties
from kma_tpu.ops.nw_kernel import (nw_band_score, nw_band_score_plain,
                                   stage_code_inputs)


def _dmat(pen):
    d = pen.score_matrix()[:5, :5].astype(np.int64)
    return d, tuple(tuple(int(x) for x in row) for row in d)


def _score(ts, qs, tls, qls, ks, bands, pen, L=None, fn=nw_band_score):
    _d, DMAT = _dmat(pen)
    tl, ql, hb, qext, tcol = stage_code_inputs(ts, qs, tls, qls,
                                               np.asarray(bands), L=L)
    return np.asarray(fn(tl, ql, np.asarray(ks, np.int32), hb, qext, tcol,
                         DMAT=DMAT, W1=pen.W1, U=pen.U, MM=pen.MM))


def _random_case(rng, B, err, lo=10, hi=300, spread=60):
    templates, queries, tl, ql, ks = [], [], [], [], []
    for _ in range(B):
        tlen = int(rng.integers(lo, hi))
        qlen = max(10, tlen + int(rng.integers(-spread, spread)))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        q = t[:qlen].copy() if qlen <= tlen else np.concatenate(
            [t, rng.integers(0, 4, qlen - tlen)]).astype(np.uint8)
        ne = rng.binomial(qlen, err)
        pos = rng.integers(0, qlen, ne)
        q[pos] = (q[pos] + rng.integers(1, 4, ne)) % 4
        templates.append(t)
        queries.append(q)
        tl.append(tlen)
        ql.append(qlen)
        ks.append(int(rng.choice([0, 1, -1, 2, -2])))
    return templates, queries, tl, ql, ks


@pytest.mark.parametrize("seed,err", [(5, 0.08), (99, 0.2)])
def test_nw_band_score_pallas_exact(seed, err):
    """Scores bit-match nw_band (itself nw_oracle-exact) across k modes,
    length ratios, and band geometries -- incl. the reference's stale
    double-buffer reads that the k == -2 final scan observes."""
    pen = Penalties()
    d, _ = _dmat(pen)
    rng = np.random.default_rng(seed)
    band = 64
    ts, qs, tl, ql, ks = _random_case(rng, 32, err)
    exp = [nw_band(ts[b], qs[b], ks[b], 0, tl[b], 0, ql[b], band, d,
                   pen.W1, pen.U, pen.MM, tl[b]).score for b in range(32)]
    assert _score(ts, qs, tl, ql, ks, [band] * 32, pen).tolist() == exp


def test_nw_band_score_pallas_mixed_bands():
    """Per-alignment runtime bands: alignments with different band
    widths share one dispatch (the production lead/trail windows mix
    bands 64..126), at the production lane width of 256."""
    pen = Penalties()
    d, _ = _dmat(pen)
    rng = np.random.default_rng(17)
    B = 16
    ts, qs, tl, ql, ks = _random_case(rng, B, 0.1, 30, 200, 30)
    bands = np.asarray([int(rng.choice([64, 80, 100, 126]))
                        for _ in range(B)], np.int32)
    bands += bands & 1
    exp = [nw_band(ts[b], qs[b], ks[b], 0, tl[b], 0, ql[b], int(bands[b]),
                   d, pen.W1, pen.U, pen.MM, tl[b]).score for b in range(B)]
    got = _score(ts, qs, tl, ql, ks, bands, pen, L=256)
    assert got.tolist() == exp


def test_nw_codes_and_qext_kernels_oracle():
    """N query codes, per-alignment bands and bands wider than the
    alignment (the K<0 saturation) through the platform dispatcher and
    the plain implementation alike."""
    pen = Penalties()
    d, _ = _dmat(pen)
    rng = np.random.default_rng(29)
    B = 16
    ts, qs, tls, qls, kf, bands = [], [], [], [], [], []
    for b in range(B):
        band = [16, 32, 64, 126][b % 4]
        tlen = int(rng.integers(4, 160))
        qlen = max(1, tlen + int(rng.integers(-band // 2, band // 2 + 1)))
        ts.append(rng.integers(0, 4, tlen).astype(np.uint8))
        qs.append(rng.integers(0, 5, qlen).astype(np.uint8))
        tls.append(tlen)
        qls.append(qlen)
        kf.append([0, 1, -1, 2, -2][b % 5])
        bands.append(band)
    exp = [nw_band(ts[b], qs[b], kf[b], 0, tls[b], 0, qls[b],
                   bands[b] + (bands[b] & 1), d, pen.W1, pen.U, pen.MM,
                   tls[b]).score for b in range(B)]
    assert _score(ts, qs, tls, qls, kf, bands, pen).tolist() == exp
    assert _score(ts, qs, tls, qls, kf, bands, pen,
                  fn=nw_band_score_plain).tolist() == exp


@pytest.mark.gpu
def test_nw_cuda_kernel_matches_plain(gpu):
    """The CUDA kernel (native/nw_band.cu) equals the plain version on
    random windows at both lane widths it is built for."""
    pen = Penalties()
    rng = np.random.default_rng(41)
    ts, qs, tl, ql, ks = _random_case(rng, 96, 0.1, 10, 400, 60)
    for L in (128, 256):
        got = _score(ts, qs, tl, ql, ks, [64] * 96, pen, L=L)
        ref = _score(ts, qs, tl, ql, ks, [64] * 96, pen, L=L,
                     fn=nw_band_score_plain)
        assert got.tolist() == ref.tolist()

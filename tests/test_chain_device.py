"""Device chain scanner (mapping/chain_device.py): the device hash-probe
front-end must feed the native chainer the exact hit stream the host
lookup produces, so DeviceChainStream == per-read NativeChain.scan.

Runs on the CPU jax backend against the seeded gene panel; the lookup
jit is backend-agnostic."""

import numpy as np
import pytest

from kma_tpu.config import Penalties
from kma_tpu.index.format import load_index
from kma_tpu.mapping.chain_device import DeviceChainStream
from kma_tpu.mapping.native_chain import make_native_chain
from kma_tpu.mapping.scan import lookup_voff, scan_keys
from kma_tpu.io.seq import rc_codes, valid_kmer_mask


@pytest.fixture(scope="module")
def db50_prefix(panel):
    return panel["db"]


@pytest.fixture(scope="module")
def db50i(db50_prefix):
    return load_index(db50_prefix)


def test_device_lookup_matches_host(db50i, db50_prefix):
    """Per-window voffs from the device == lookup_voff, both strands."""
    idx = db50i
    pen = Penalties()
    tl = idx.template_lengths.astype(np.int64)
    nch = make_native_chain(idx, pen, tl)
    dcs = DeviceChainStream(idx, pen, tl, nch, batch=64)
    k = idx.kmersize
    rng = np.random.default_rng(5)
    from kma_tpu.pipeline import TemplateStore
    store = TemplateStore(db50_prefix + ".seq.b", tl, k)
    for tid in (3, 17, 22):
        t = store.get(tid).codes
        c = t[: 150].copy()
        c[rng.integers(0, len(c), 4)] = 4  # Ns

        class R:
            codes = c
            header = b"x\x00"
        disp = dcs._dispatch([R()])
        assert disp is not None
        _, rows_f, rows_rc, _rle = disp
        voff_f = dcs._rows_to_voff(np.asarray(rows_f))[0]
        voff_r = dcs._rows_to_voff(np.asarray(rows_rc))[0]
        W = len(c) - k + 1
        km_f = scan_keys(idx, c)
        ok_f = valid_kmer_mask(c, k)
        cr = rc_codes(c)
        km_r = scan_keys(idx, cr)
        for q in range(W):
            exp = lookup_voff(idx, int(km_f[q])) if ok_f[q] else -1
            assert voff_f[q] == exp, ("fw", q)
            # entry q of the rc row = rc window at rc-coordinate W-1-q
            p = W - 1 - q
            exp_r = lookup_voff(idx, int(km_r[p])) if ok_f[q] else -1
            assert voff_r[q] == exp_r, ("rc", q)


def test_device_chain_stream_matches_native(db50i, db50_prefix):
    idx = db50i
    pen = Penalties()
    tl = idx.template_lengths.astype(np.int64)
    nch = make_native_chain(idx, pen, tl)
    assert nch is not None
    dcs = DeviceChainStream(idx, pen, tl, nch, batch=37)
    from kma_tpu.pipeline import TemplateStore
    store = TemplateStore(db50_prefix + ".seq.b", tl, idx.kmersize)
    rng = np.random.default_rng(11)
    recs = [store.get(int(i)).codes
            for i in rng.integers(1, idx.db_size, 25)]

    reads = []
    for i in range(160):
        t = recs[rng.integers(len(recs))]
        ln = int(rng.integers(8, min(300, len(t) + 1)))
        s = int(rng.integers(0, len(t) - ln + 1))
        c = t[s:s + ln].copy()
        r = rng.random()
        if r < 0.3:
            ne = rng.binomial(ln, 0.04)
            pp = rng.integers(0, ln, ne)
            c[pp] = (c[pp] + rng.integers(1, 4, ne)) % 4
        elif r < 0.5:
            c[rng.integers(0, ln, rng.integers(1, 6))] = 4
        elif r < 0.65:
            t2 = recs[rng.integers(len(recs))]
            c = np.concatenate([c, t2[:int(rng.integers(20, 150))]])
        elif r < 0.8:
            c = rc_codes(c)

        class R:
            pass
        rd = R()
        rd.codes = np.ascontiguousarray(c, np.uint8)
        rd.header = b"d%d\x00" % i
        reads.append(rd)

    def key(h):
        return (h.rc_flag, h.templates.tolist(), h.header,
                h.codes.tobytes(), h.n_positions.tolist())

    db = idx.db_size
    S, E = np.zeros(db, np.int64), np.zeros(db, np.int64)
    I = np.zeros(db, np.uint8)
    args = (False, 16, 0.1, 0.5, 0.0, False)
    got = list(dcs.stream(reads, *args))
    assert len(got) == len(reads)
    for (r, hits), rd in zip(got, reads):
        assert r is rd
        exp = nch.scan(rd.codes, rd.header, False, S, E, I,
                       16, 0.1, 0.5, 0.0, False)
        assert [key(h) for h in hits] == [key(h) for h in exp], rd.header


def test_device_lookup_rle_long_reads(db50i, db50_prefix):
    """The RLE-compacted transfer (W >= 512) reconstructs the exact
    dense rows, including rows whose run count overflows the static cap
    (host re-derivation path)."""
    idx = db50i
    pen = Penalties()
    tl = idx.template_lengths.astype(np.int64)
    nch = make_native_chain(idx, pen, tl)
    dcs = DeviceChainStream(idx, pen, tl, nch, batch=8)
    k = idx.kmersize
    rng = np.random.default_rng(11)
    from kma_tpu.mapping.chain_device import (_chain_lookup, _rle_cap,
                                              _pad_len)
    from kma_tpu.pipeline import TemplateStore
    store = TemplateStore(db50_prefix + ".seq.b", tl, k)
    reads = []
    # stitched long read (few runs), noisy long read (many runs), and an
    # adversarial alternator (hit k-mer / junk) to force cap overflow
    t1 = store.get(3).codes
    t2 = store.get(17).codes
    long1 = np.concatenate([t1, t2, t1])[:900].copy()
    noisy = np.concatenate([t2, t1, t2])[:900].copy()
    pos = rng.integers(0, len(noisy), 90)
    noisy[pos] = (noisy[pos] + rng.integers(1, 4, 90)) % 4
    alt = np.empty(900, np.uint8)
    for i in range(0, 900, 2 * k):
        a = alt[i: i + k]
        a[:] = t1[: len(a)]
        b = alt[i + k: i + 2 * k]
        b[:] = rng.integers(0, 4, len(b)).astype(np.uint8)
    reads += [long1, noisy, alt]
    L = _pad_len(900)
    W = L - k + 1
    assert W >= 512  # the RLE branch engages
    codes = np.full((len(reads), L), 4, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for j, c in enumerate(reads):
        codes[j, : len(c)] = c
        lengths[j] = len(c)
    d = dcs.didx
    ref_f, ref_rc = _chain_lookup(d.exist, d.kv, codes, lengths, k=k,
                                  mega=d.mega, size=d.size,
                                  max_probe=d.max_probe)
    from kma_tpu.mapping.chain_device import chain_lookup_dense
    got_f, got_rc = chain_lookup_dense(d, idx, codes, lengths)
    assert np.array_equal(np.asarray(ref_f), got_f)
    assert np.array_equal(np.asarray(ref_rc), got_rc)

    # overflow machinery under a tiny explicit cap: every row busts the
    # cap and goes through the exact host re-derivation (_host_rows)
    from kma_tpu.mapping.chain_device import (_chain_lookup_rle_jit,
                                              _expand_rle, _host_rows)
    R = 4
    sf, vf, nf, sr, vr, nr = (np.asarray(x) for x in _chain_lookup_rle_jit()(
        d.exist, d.kv, codes, lengths, k=k, mega=d.mega, size=d.size,
        max_probe=d.max_probe, R=R))
    assert (nf > R).any() or (nr > R).any()
    rf = _expand_rle(sf, vf, nf, W)
    rrc = _expand_rle(sr, vr, nr, W)
    over = np.flatnonzero((nf > R) | (nr > R))
    _host_rows(d, idx, codes, lengths, over, rf, rrc)
    assert np.array_equal(np.asarray(ref_f), rf)
    assert np.array_equal(np.asarray(ref_rc), rrc)

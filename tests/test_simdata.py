"""Seeded gene-panel generator (kma_tpu/utils/simdata.py)."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from kma_tpu.io.seq import kmer_scan, rc_codes, parse_fasta
from kma_tpu.utils import simdata

K = 16


def _kmers(codes):
    return set(kmer_scan(np.asarray(codes, np.uint8), K).tolist())


def _read_fastq(path):
    out = []
    with open(path) as f:
        lines = f.read().split("\n")
    for i in range(1, len(lines) - 1, 4):
        out.append(np.frombuffer(lines[i].encode(), np.uint8))
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    return [lut[r] for r in out]


@pytest.mark.parametrize("seed", [1, 7])
def test_same_seed_same_bytes(tmp_path, seed):
    a = simdata.generate(str(tmp_path / "a"), seed, simdata.SMALL)
    b = simdata.generate(str(tmp_path / "b"), seed, simdata.SMALL)
    c = simdata.generate(str(tmp_path / "c"), seed + 1, simdata.SMALL)
    for key in ("fasta", "se", "pe1", "pe2", "ont"):
        assert filecmp.cmp(a[key], b[key], shallow=False), key
        assert not filecmp.cmp(a[key], c[key], shallow=False), key


def test_family_structure():
    s = dataclasses.replace(simdata.SMALL, families=12, templates=60,
                            max_family=9)
    names, seqs, fam = simdata.make_panel(np.random.default_rng(3), s)
    assert len(seqs) == len(names) == s.templates
    sizes = np.bincount(fam)
    assert len(sizes) == s.families
    assert sizes.min() >= 1 and sizes.max() <= s.max_family
    for f in range(s.families):
        members = np.flatnonzero(fam == f)
        base = seqs[members[0]]
        assert s.min_len <= len(base) <= s.max_len
        kb = _kmers(base)
        for m in members[1:]:
            # a few SNPs and short indels away from the family base
            assert abs(len(seqs[m]) - len(base)) <= 6
            shared = len(_kmers(seqs[m]) & kb) / len(kb)
            assert 0.5 < shared < 1.0, (f, m, shared)
    # families are unrelated to each other
    b0 = _kmers(seqs[np.flatnonzero(fam == 0)[0]])
    b1 = _kmers(seqs[np.flatnonzero(fam == 1)[0]])
    assert len(b0 & b1) == 0


def test_reads_map_back_to_their_source():
    s = simdata.SMALL
    rng = np.random.default_rng(5)
    _names, seqs, _fam = simdata.make_panel(rng, s)
    panel = set().union(*(_kmers(q) for q in seqs))

    def frac(read, src):
        km = _kmers(src)
        return max(len(_kmers(r) & km) / max(len(_kmers(r)), 1)
                   for r in (read, rc_codes(read)))

    se, src = simdata.make_se(np.random.default_rng(6), seqs, s)
    assert 0 < (src >= 0).mean() < 1
    for i in range(0, len(se), 7):
        if src[i] >= 0:
            assert frac(se[i], seqs[src[i]]) > 0.3, i
        else:
            assert len(_kmers(se[i]) & panel) <= 2, i
    r1, r2, src = simdata.make_pe(np.random.default_rng(7), seqs, s)
    for i in range(0, len(r1), 5):
        assert frac(r1[i], seqs[src[i]]) > 0.3
        assert frac(r2[i], seqs[src[i]]) > 0.3
    ont, src = simdata.make_ont(np.random.default_rng(8), seqs, s)
    for r, t in zip(ont, src):
        assert s.ont_min * 0.9 <= len(r) <= s.ont_max * 1.1
        assert len(_kmers(r) | _kmers(rc_codes(r))) and \
            frac(r, seqs[t]) > 0.02
    w = simdata.make_nw_windows(np.random.default_rng(9), 64)
    w2 = simdata.make_nw_windows(np.random.default_rng(9), 64)
    assert len(w["t"]) == 64 and w["band"] == w2["band"]
    assert all(np.array_equal(a, b) for a, b in zip(w["q"], w2["q"]))
    for t, q, tl, ql, band in zip(w["t"], w["q"], w["tl"], w["ql"],
                                  w["band"]):
        assert len(t) == tl and len(q) == ql and band <= 128
        assert abs(ql - tl) <= band // 2 or ql == 16


def test_panel_fasta_and_index(panel):
    recs = list(parse_fasta(panel["fasta"]))
    assert len(recs) == simdata.SMALL.templates
    assert recs[0][0] == b">fam000_v00"
    for ext in (".comp.b", ".length.b", ".name", ".seq.b"):
        assert os.path.getsize(panel["db"] + ext) > 0

"""Seeded gene-panel data: a redundant reference panel and read sets.

The panel has the shape of ResFinder, the database the KMA paper maps
against: a few thousand genes of 600-2,400 bp in families of 1-30
variants that differ by a few SNPs and short indels.  That redundancy is
what ConClave and the tie lists resolve.  The read sets are one
Illumina isolate's worth against the panel:

- single-end reads (100 bp, ~1% substitutions): a small share drawn from
  a handful of panel genes on both strands, the rest background sequence
  that maps nowhere;
- paired-end reads (2 x 100 bp, insert 205) chopped from the panel
  templates, as the paper's chop_DB recipe does;
- Nanopore-like reads (1-20 kb, ~7% substitutions and indels) that carry
  a panel gene, or part of one, inside background flanks.

make_nw_windows adds seeded banded-NW windows (query, template, band)
for the kernel checks.

Every file is a pure function of the seed and the sizes.

    python -m kma_tpu.utils.simdata -o DIR [--seed 1] [--index] [--small]
                                    [--se N] [--pe N] [--ont N]

writes DIR/panel.fsa, se.fq, pe_1.fq, pe_2.fq and ont.fq, and with
--index builds DIR/panel.* with the repository's own ``kma index``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.array([3, 2, 1, 0], np.uint8)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Data scale; the defaults are the gene-panel deployment."""

    families: int = 300
    templates: int = 2400
    min_len: int = 600
    max_len: int = 2400
    max_family: int = 30
    se: int = 1_000_000
    se_len: int = 100
    se_err: float = 0.01
    se_mapped: float = 0.05
    se_genes: int = 8
    pe: int = 200_000
    pe_len: int = 100
    insert: int = 205
    ont: int = 2000
    ont_min: int = 1000
    ont_max: int = 20000
    ont_err: float = 0.07


SMALL = Sizes(families=6, templates=24, min_len=600, max_len=900,
              max_family=8, se=600, pe=200, ont=8, ont_min=1000,
              ont_max=2500, se_genes=4, se_mapped=0.5)


def _family_sizes(rng, n_fam: int, n_tpl: int, cap: int) -> np.ndarray:
    """Family sizes in [1, cap] summing to n_tpl (n_fam <= n_tpl <=
    n_fam * cap): geometric-like draws, then trimmed or topped up."""
    sizes = np.clip(rng.geometric(n_fam / n_tpl, n_fam), 1, cap)
    while sizes.sum() != n_tpl:
        i = int(rng.integers(n_fam))
        if sizes.sum() > n_tpl and sizes[i] > 1:
            sizes[i] -= 1
        elif sizes.sum() < n_tpl and sizes[i] < cap:
            sizes[i] += 1
    return sizes


def _mutate_variant(rng, base: np.ndarray) -> np.ndarray:
    """A family member: 1-8 SNPs and 0-2 indels of 1-3 bp."""
    v = base.copy()
    pos = rng.integers(0, len(v), int(rng.integers(1, 9)))
    v[pos] = (v[pos] + rng.integers(1, 4, len(pos))) % 4
    for _ in range(int(rng.integers(0, 3))):
        p = int(rng.integers(10, len(v) - 10))
        n = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            v = np.concatenate([v[:p], rng.integers(0, 4, n).astype(np.uint8),
                                v[p:]])
        else:
            v = np.concatenate([v[:p], v[p + n:]])
    return v


def make_panel(rng, s: Sizes) -> Tuple[List[str], List[np.ndarray],
                                       np.ndarray]:
    """Returns (names, template codes, family id per template)."""
    sizes = _family_sizes(rng, s.families, s.templates, s.max_family)
    names, seqs, fam = [], [], []
    for f, n in enumerate(sizes.tolist()):
        base = rng.integers(0, 4, int(rng.integers(s.min_len,
                                                   s.max_len + 1))
                            ).astype(np.uint8)
        for v in range(n):
            seqs.append(base if v == 0 else _mutate_variant(rng, base))
            names.append("fam%03d_v%02d" % (f, v))
            fam.append(f)
    return names, seqs, np.asarray(fam, np.int32)


def _substitute(rng, reads: np.ndarray, rate: float) -> None:
    hit = rng.random(reads.shape) < rate
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4


def _fastq_fixed(path: str, prefix: str, reads: np.ndarray,
                 start: int = 0, suffix: str = "") -> None:
    """Fixed-length reads [N, L] u8 codes -> FASTQ, built as one buffer."""
    n, L = reads.shape
    if n == 0:
        open(path, "wb").close()
        return
    head = ["@%s%09d%s\n" % (prefix, i, suffix) for i in range(start,
                                                               start + n)]
    hw = len(head[0])
    rec = np.empty((n, hw + 2 * L + 4), np.uint8)
    rec[:, :hw] = np.frombuffer("".join(head).encode(), np.uint8
                                ).reshape(n, hw)
    rec[:, hw: hw + L] = _BASES[reads]
    rec[:, hw + L: hw + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, hw + L + 3: hw + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def _windows(rng, seqs, which: np.ndarray, L: int) -> np.ndarray:
    """One random L-window of seqs[which[i]] per row (templates >= L)."""
    out = np.empty((len(which), L), np.uint8)
    for t in np.unique(which).tolist():
        rows = np.flatnonzero(which == t)
        seq = seqs[t]
        st = rng.integers(0, len(seq) - L + 1, len(rows))
        out[rows] = seq[st[:, None] + np.arange(L)[None, :]]
    return out


def _rc_rows(reads: np.ndarray, flip: np.ndarray) -> None:
    reads[flip] = _COMP[reads[flip, ::-1]]


def make_se(rng, seqs, s: Sizes) -> Tuple[np.ndarray, np.ndarray]:
    """SE reads and their source template (-1 = background)."""
    genes = rng.choice(len(seqs), size=min(s.se_genes, len(seqs)),
                       replace=False)
    src = np.full(s.se, -1, np.int64)
    mapped = rng.random(s.se) < s.se_mapped
    src[mapped] = rng.choice(genes, int(mapped.sum()))
    reads = rng.integers(0, 4, (s.se, s.se_len)).astype(np.uint8)
    rows = np.flatnonzero(mapped)
    reads[rows] = _windows(rng, seqs, src[rows], s.se_len)
    _substitute(rng, reads, s.se_err)
    _rc_rows(reads, rng.random(s.se) < 0.5)
    return reads, src


def make_pe(rng, seqs, s: Sizes) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """chop_DB-style pairs: (mate 1, mate 2, source template)."""
    src = rng.integers(0, len(seqs), s.pe)
    frag = _windows(rng, seqs, src, s.insert)
    r1 = frag[:, : s.pe_len].copy()
    r2 = _COMP[frag[:, -s.pe_len:][:, ::-1]]
    _substitute(rng, r1, s.se_err)
    _substitute(rng, r2, s.se_err)
    flip = rng.random(s.pe) < 0.5
    r1[flip], r2[flip] = r2[flip].copy(), r1[flip].copy()
    return r1, r2, src


def _long_errors(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """Substitutions, insertions and deletions at rate/3 each."""
    u = rng.random(len(seq))
    sub = u < rate / 3
    out = seq.copy()
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    keep = ~((u >= rate / 3) & (u < 2 * rate / 3))
    ins = (u >= 2 * rate / 3) & (u < rate)
    reps = keep.astype(np.int64) + ins
    out = np.repeat(out, reps)
    # the second copy of each inserted base becomes a random base
    first = np.cumsum(reps) - reps
    ins_at = first[ins] + 1
    out[ins_at] = rng.integers(0, 4, len(ins_at))
    return out


def make_ont(rng, seqs, s: Sizes) -> Tuple[List[np.ndarray], np.ndarray]:
    """Long reads: background flanks around a panel gene or part of it."""
    lens = np.exp(rng.uniform(np.log(s.ont_min), np.log(s.ont_max), s.ont)
                  ).astype(np.int64)
    src = rng.integers(0, len(seqs), s.ont)
    reads = []
    for L, t in zip(lens.tolist(), src.tolist()):
        gene = seqs[t]
        if L > len(gene):
            left = int(rng.integers(0, L - len(gene) + 1))
            core = np.concatenate([
                rng.integers(0, 4, left).astype(np.uint8), gene,
                rng.integers(0, 4, L - len(gene) - left).astype(np.uint8)])
        else:
            st = int(rng.integers(0, len(gene) - L + 1))
            core = gene[st: st + L]
        r = _long_errors(rng, core, s.ont_err)
        if rng.random() < 0.5:
            r = _COMP[r[::-1]]
        reads.append(r)
    return reads, src


def make_nw_windows(rng, n: int, max_t: int = 1024,
                    bands=(64, 80, 100, 126, 128)) -> dict:
    """n banded-NW windows for the kernel checks: a random template of
    64..max_t bp, a query of the same bases at 10% substitutions whose
    length differs by less than half the band, an end flag (kf) and a
    band of at most 128."""
    out = {k: [] for k in ("t", "q", "tl", "ql", "kf", "band")}
    for _ in range(n):
        band = int(rng.choice(bands))
        tlen = int(rng.integers(64, max_t))
        qlen = max(16, tlen + int(rng.integers(-band // 2, band // 2)))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        q = np.resize(t, qlen).copy()
        ne = rng.binomial(qlen, 0.1)
        pos = rng.integers(0, qlen, ne)
        q[pos] = rng.integers(0, 5, ne)
        for k, v in (("t", t), ("q", q), ("tl", tlen), ("ql", qlen),
                     ("kf", int(rng.choice([0, 1, -1, 2, -2]))),
                     ("band", band)):
            out[k].append(v)
    return out


def write_fasta(path: str, names, seqs) -> None:
    with open(path, "w") as f:
        for n, c in zip(names, seqs):
            f.write(">%s\n%s\n" % (n, _BASES[c].tobytes().decode()))


def write_fastq(path: str, prefix: str, reads) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write("@%s%06d\n%s\n+\n%s\n"
                    % (prefix, i, _BASES[r].tobytes().decode(),
                       "5" * len(r)))


def generate(out_dir: str, seed: int = 1, sizes: Sizes = Sizes(),
             index: bool = False) -> dict:
    """Write the panel and the read sets under out_dir; returns paths."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names, seqs, _fam = make_panel(rng, sizes)
    p = {k: os.path.join(out_dir, v) for k, v in (
        ("fasta", "panel.fsa"), ("se", "se.fq"), ("pe1", "pe_1.fq"),
        ("pe2", "pe_2.fq"), ("ont", "ont.fq"), ("db", "panel"))}
    write_fasta(p["fasta"], names, seqs)
    se, _ = make_se(np.random.default_rng([seed, 1]), seqs, sizes)
    _fastq_fixed(p["se"], "se", se)
    r1, r2, _ = make_pe(np.random.default_rng([seed, 2]), seqs, sizes)
    _fastq_fixed(p["pe1"], "pe", r1, suffix="/1")
    _fastq_fixed(p["pe2"], "pe", r2, suffix="/2")
    ont, _ = make_ont(np.random.default_rng([seed, 3]), seqs, sizes)
    write_fastq(p["ont"], "ont", ont)
    if index:
        subprocess.run([os.path.join(REPO, "bin", "kma"), "index", "-i",
                        p["fasta"], "-o", p["db"]], check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--index", action="store_true",
                    help="build OUT/panel with bin/kma index")
    ap.add_argument("--small", action="store_true",
                    help="test-sized data (simdata.SMALL)")
    for name in ("se", "pe", "ont"):
        ap.add_argument("--" + name, type=int, default=None,
                        help="number of %s reads" % name.upper())
    a = ap.parse_args(argv)
    over = {n: getattr(a, n) for n in ("se", "pe", "ont")
            if getattr(a, n) is not None}
    sizes = dataclasses.replace(SMALL if a.small else Sizes(), **over)
    paths = generate(a.out, a.seed, sizes, index=a.index)
    print("\n".join("%s\t%s" % kv for kv in paths.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

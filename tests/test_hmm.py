"""Golden tests for the -hmm scanner (save_kmers_HMM) vs the reference."""

import gzip
import subprocess

import numpy as np
import pytest

from kma_tpu.cli.main import main as kma_main
from kma_tpu.io.seq import parse_fasta


@pytest.fixture(scope="module")
def db50_index(tmp_path_factory, db50, ref_index_bin):
    d = tmp_path_factory.mktemp("db_idx_hmm")
    prefix = str(d / "db")
    subprocess.run([str(ref_index_bin), "-i", str(db50), "-o", prefix],
                   check=True, capture_output=True)
    return prefix


@pytest.fixture(scope="module")
def hmm_reads(tmp_path_factory, db50):
    """Mixed workload for the HMM region splitter: short reads, long
    chimeric reads (multiple regions per read), N-interrupted reads."""
    rng = np.random.default_rng(77)
    recs = list(parse_fasta(str(db50)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    out = tmp_path_factory.mktemp("hmm") / "hmm.fq"

    def mutate(r, sub=0.03, indel=0.01):
        o = []
        for c in r:
            x = rng.random()
            if x < indel / 2:
                continue
            if x < indel:
                o.append(int(rng.integers(0, 4)))
            if rng.random() < sub:
                o.append(int((c + rng.integers(1, 4)) % 4))
            else:
                o.append(int(c))
        return np.array(o, dtype=np.uint8)

    with open(out, "w") as f:
        n = 0
        # short reads
        for _ in range(150):
            _h, codes = recs[rng.integers(len(recs))]
            L = int(rng.integers(80, 150))
            if len(codes) <= L:
                continue
            s = int(rng.integers(0, len(codes) - L))
            r = mutate(codes[s: s + L])
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write(f"@s{n}\n{''.join('ACGTN'[c] for c in r)}\n+\n"
                    f"{'I' * len(r)}\n")
            n += 1
        # chimeric long reads: junk spacers between template segments
        for i in range(60):
            nseg = int(rng.integers(1, 4))
            parts = []
            for _s in range(nseg):
                _h, codes = recs[rng.integers(len(recs))]
                L = int(rng.integers(200, min(800, len(codes))))
                st = int(rng.integers(0, len(codes) - L + 1))
                seg = mutate(codes[st: st + L])
                if rng.random() < 0.5:
                    seg = comp[seg[::-1]]
                parts.append(seg)
                parts.append(rng.integers(0, 4, int(rng.integers(0, 120))
                                          ).astype(np.uint8))
            r = np.concatenate(parts)
            f.write(f"@c{i}\n{''.join('ACGTN'[c] for c in r)}\n+\n"
                    f"{'I' * len(r)}\n")
        # N-interrupted reads
        for i in range(30):
            _h, codes = recs[rng.integers(len(recs))]
            L = int(rng.integers(150, min(400, len(codes))))
            st = int(rng.integers(0, len(codes) - L + 1))
            r = mutate(codes[st: st + L])
            npos = rng.integers(10, max(11, len(r) - 10),
                                int(rng.integers(1, 5)))
            r[npos] = 4
            f.write(f"@x{i}\n{''.join('ACGTN'[c] for c in r)}\n+\n"
                    f"{'I' * len(r)}\n")
    return out


def _run_both(tmp_path, reads, db, ref_bin, extra):
    ref_out = tmp_path / "ref"
    my_out = tmp_path / "my"
    r = subprocess.run([str(ref_bin), "-i", str(reads), "-o", str(ref_out),
                        "-t_db", db] + extra, capture_output=True)
    assert r.returncode == 0, r.stderr
    rc = kma_main(["-i", str(reads), "-o", str(my_out), "-t_db", db]
                  + extra)
    assert rc == 0
    for ext in (".res", ".fsa", ".aln"):
        a = (ref_out.parent / (ref_out.name + ext)).read_bytes()
        b = (my_out.parent / (my_out.name + ext)).read_bytes()
        assert a == b, f"{ext} differs"
    a = gzip.open(str(ref_out) + ".frag.gz").read()
    b = gzip.open(str(my_out) + ".frag.gz").read()
    assert a == b, ".frag.gz content differs"


def test_hmm_parity(tmp_path, hmm_reads, db50_index, ref_bin):
    """-hmm region splitting: full output parity incl. spliced frag
    names with the \\tstart\\tend suffix (savekmers.c:3866-4522)."""
    _run_both(tmp_path, hmm_reads, db50_index, ref_bin, ["-hmm"])


def test_hmm_mem_mode_parity(tmp_path, hmm_reads, db50_index, ref_bin):
    """-hmm -mem_mode routes end-touching regions through
    ankerAndClean_MEM (savekmers.c:4852-5120)."""
    _run_both(tmp_path, hmm_reads, db50_index, ref_bin,
              ["-hmm", "-mem_mode"])


@pytest.mark.parametrize("extra", [["-hmm"], ["-hmm", "-mem_mode"]])
def test_hmm_native_cli_parity(tmp_path, hmm_reads, db50_index, ref_bin,
                               extra):
    """The NATIVE CLI's -hmm mode (kma_run.cpp scan_read_hmm) is
    byte-identical to the reference on the same mixed workload."""
    import os
    from pathlib import Path
    cli = Path(__file__).resolve().parent.parent / "native" / "kma_cli"
    if not cli.exists():
        pytest.skip("native CLI not built")
    ref_out = tmp_path / "ref"
    my_out = tmp_path / "my"
    r = subprocess.run([str(ref_bin), "-i", str(hmm_reads), "-o",
                       str(ref_out), "-t_db", db50_index] + extra,
                       capture_output=True)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ)
    r = subprocess.run([str(cli), "-i", str(hmm_reads), "-o", str(my_out),
                        "-t_db", db50_index] + extra,
                       capture_output=True, env=env)
    assert r.returncode == 0, r.stderr
    for ext in (".res", ".fsa", ".aln"):
        a = (ref_out.parent / (ref_out.name + ext)).read_bytes()
        b = (my_out.parent / (my_out.name + ext)).read_bytes()
        assert a == b, f"{ext} differs"
    a = gzip.open(str(ref_out) + ".frag.gz").read()
    b = gzip.open(str(my_out) + ".frag.gz").read()
    assert a == b, ".frag.gz content differs"

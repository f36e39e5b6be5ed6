"""k>16 cmer DBs (round 5) + the minimizer+HMM hLenR emulation.

1. Native envelope: cmer DBs (HC/minimizer/both) with kmersize > 16 run
   natively at byte parity with the reference (the old gate routed them
   to the Python scanner; window_kmers' per-window transforms are exact
   for any k <= 31).
2. Pure-minimizer DBs + -hmm: save_kmers_HMM reads the UNINITIALIZED
   hLenR (savekmers.c:3874, only hLen set at :3935), so getMmerR scans
   with *kmersize = stack garbage and x86 mod-64 shifts collapse every
   rc seed probe's cmer to 0 until the read's first hit region runs an
   initCmer.  Both the native kchain_hmm_region and the Python scanner
   emulate this (vr0/hfix), asserted here against the compiled oracle.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import db50, ref_bin, ref_index_bin, resfinder  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(REPO, "native", "kma_cli")


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def cmer_reads(tmp_path_factory, db50):
    from kma_tpu.io.seq import parse_fasta
    rng = np.random.default_rng(9)
    recs = list(parse_fasta(str(db50)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    out = tmp_path_factory.mktemp("cmer") / "reads.fq"
    with open(out, "w") as f:
        for n in range(150):
            _h, codes = recs[rng.integers(len(recs))]
            L = min(len(codes), int(rng.integers(200, 700)))
            s = int(rng.integers(0, max(1, len(codes) - L)))
            r = []
            for c in codes[s: s + L]:
                r.append(c)
                # homopolymer stretches stress the HC fold
                if rng.random() < 0.05:
                    r += [c] * int(rng.integers(1, 5))
                if rng.random() < 0.02 and r:
                    r.pop()
            r = np.array(r[:1500], np.uint8)
            ne = rng.binomial(len(r), 0.04)
            pos = rng.integers(0, len(r), ne)
            r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write("@c%d\n%s\n+\n%s\n"
                    % (n, "".join("ACGTN"[c] for c in r), "I" * len(r)))
    return out


def _index(tmp_path_factory, db50, ref_index_bin, flags, name):
    d = tmp_path_factory.mktemp("cmer_db")
    prefix = str(d / name)
    subprocess.run([str(ref_index_bin), "-i", str(db50), "-o", prefix]
                   + flags, check=True, capture_output=True)
    return prefix


@pytest.fixture(scope="module")
def db_k17hc(tmp_path_factory, db50, ref_index_bin):
    return _index(tmp_path_factory, db50, ref_index_bin,
                  ["-k", "17", "-hc"], "k17hc")


@pytest.fixture(scope="module")
def db_k24m16(tmp_path_factory, db50, ref_index_bin):
    return _index(tmp_path_factory, db50, ref_index_bin,
                  ["-k", "24", "-m", "16"], "k24m16")


@pytest.fixture(scope="module")
def db_k20m14hc(tmp_path_factory, db50, ref_index_bin):
    return _index(tmp_path_factory, db50, ref_index_bin,
                  ["-k", "20", "-m", "14", "-hc"], "k20m14hc")


def _run_pair(tmp_path, ref_bin, db, reads, margs, exe):
    ref_out = str(tmp_path / "ref")
    my_out = str(tmp_path / "my")
    r = subprocess.run([str(ref_bin), "-i", str(reads), "-t_db", db,
                        "-o", ref_out, "-t", "1"] + margs,
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    r = subprocess.run(exe + ["-i", str(reads), "-t_db", db, "-o",
                              my_out, "-t", "1", "-device", "off"]
                       + margs, capture_output=True, env=_env())
    assert r.returncode == 0, r.stderr.decode()[-500:]
    assert r.returncode != 113
    for ext in (".res", ".fsa", ".aln"):
        a = open(ref_out + ext, "rb").read()
        b = open(my_out + ext, "rb").read()
        assert a == b, ext


@pytest.mark.parametrize("margs", [["-1t1"], [], ["-mem_mode"], ["-hmm"]])
@pytest.mark.parametrize("dbfix", ["db_k17hc", "db_k24m16", "db_k20m14hc"])
def test_k17plus_cmer_native(tmp_path, cmer_reads, ref_bin, margs, dbfix,
                             request):
    db = request.getfixturevalue(dbfix)
    _run_pair(tmp_path, ref_bin, db, cmer_reads, margs, [CLI])


@pytest.mark.parametrize("native", [True, False])
def test_minimizer_hmm_hlenr_emulation(tmp_path, cmer_reads, ref_bin,
                                       db_k24m16, native):
    """The uninitialized-hLenR behavior class on a pure-minimizer DB:
    byte parity for -hmm through both the native-engine and the
    pure-Python scanner."""
    exe = [sys.executable, "-m", "kma_tpu"]
    env = _env()
    if not native:
        env["KMA_TPU_NO_NATIVE"] = "1"
    ref_out = str(tmp_path / "ref")
    my_out = str(tmp_path / "my")
    r = subprocess.run([str(ref_bin), "-i", str(cmer_reads), "-t_db",
                        db_k24m16, "-o", ref_out, "-hmm", "-t", "1"],
                       capture_output=True)
    assert r.returncode == 0
    r = subprocess.run(exe + ["-i", str(cmer_reads), "-t_db", db_k24m16,
                              "-o", my_out, "-hmm", "-t", "1",
                              "-device", "off"],
                       capture_output=True, env=env)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    for ext in (".res", ".fsa"):
        assert open(ref_out + ext, "rb").read() \
            == open(my_out + ext, "rb").read(), ext

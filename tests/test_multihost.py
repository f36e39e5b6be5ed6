"""Multi-host runtime: 2-process jax.distributed run, shard invariance.

Launches real separate processes (Gloo CPU collectives) through the CLI
`-mh` flag and asserts the outputs are bit-identical to the
single-process run -- the spltDB-reducer-style record merge
(parallel/multihost.py) restores the exact ConClave stream order.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from kma_tpu.io.seq import parse_fasta

REPO = Path(__file__).resolve().parent.parent


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.fixture(scope="module")
def mh_env():
    env = dict(os.environ)
    # multihost runs on the Gloo CPU backend
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def mh_reads(tmp_path_factory, db50):
    rng = np.random.default_rng(17)
    recs = list(parse_fasta(str(db50)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    out = tmp_path_factory.mktemp("mh") / "reads.fq"
    with open(out, "w") as f:
        for i in range(300):
            _h, codes = recs[rng.integers(len(recs))]
            L = int(rng.integers(80, 200))
            if len(codes) <= L:
                continue
            s = int(rng.integers(0, len(codes) - L))
            r = codes[s: s + L].copy()
            ne = rng.binomial(L, 0.01)
            pos = rng.integers(0, L, ne)
            r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write("@r%d\n%s\n+\n%s\n"
                    % (i, "".join("ACGTN"[c] for c in r), "I" * len(r)))
    return out


@pytest.fixture(scope="module")
def db50_index3(tmp_path_factory, db50, ref_index_bin):
    d = tmp_path_factory.mktemp("db_mh")
    prefix = str(d / "db")
    subprocess.run([str(ref_index_bin), "-i", str(db50), "-o", prefix],
                   check=True, capture_output=True)
    return prefix


def _run_cli(args, env):
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r); "
         "from kma_tpu.cli.main import main; sys.exit(main(%r))"
         % (str(REPO), args)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def test_multihost_shard_invariance(tmp_path, mh_reads, db50_index3,
                                    mh_env):
    """N=2 jax.distributed run produces bit-identical outputs to N=1."""
    single = tmp_path / "single"
    t0 = time.time()
    p = _run_cli(["-i", str(mh_reads), "-t_db", db50_index3, "-o",
                  str(single)], mh_env)
    _, err = p.communicate(timeout=280)
    t1 = time.time() - t0
    assert p.returncode == 0, err.decode()[-2000:]

    multi = tmp_path / "multi"
    port = _free_port()
    t0 = time.time()
    procs = [_run_cli(["-i", str(mh_reads), "-t_db", db50_index3, "-o",
                       str(multi), "-mh",
                       "127.0.0.1:%d,2,%d" % (port, pid)], mh_env)
             for pid in range(2)]
    errs = [p.communicate(timeout=280)[1] for p in procs]
    t2 = time.time() - t0
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-2000:]

    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("single" + ext)).read_bytes() \
            == (tmp_path / ("multi" + ext)).read_bytes(), f"{ext} differs"
    import gzip
    assert gzip.open(str(single) + ".frag.gz").read() \
        == gzip.open(str(multi) + ".frag.gz").read()
    # scaling telemetry (interpreter startup dominates at this scale;
    # the honest number comes from bench-scale runs)
    print("\n# multihost wall: 1proc=%.1fs 2proc=%.1fs eff=%.0f%%"
          % (t1, t2, 100 * t1 / (2 * t2)))


@pytest.fixture(scope="module")
def mh_pairs(tmp_path_factory, db50):
    rng = np.random.default_rng(23)
    recs = [c for _h, c in parse_fasta(str(db50)) if len(c) >= 260]
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    d = tmp_path_factory.mktemp("mhpe")
    f1p, f2p = d / "p_1.fq", d / "p_2.fq"
    with open(f1p, "w") as a, open(f2p, "w") as b:
        for i in range(200):
            t = recs[rng.integers(len(recs))]
            s = int(rng.integers(0, len(t) - 250))
            fr = t[s:s + 250]
            m1 = fr[:100].copy()
            m2 = comp[fr[150:250]][::-1].copy()
            for m in (m1, m2):
                ne = rng.binomial(100, 0.02)
                pp = rng.integers(0, 100, ne)
                m[pp] = (m[pp] + rng.integers(1, 4, ne)) % 4
            a.write("@p%d/1\n%s\n+\n%s\n"
                    % (i, "".join("ACGTN"[c] for c in m1), "I" * 100))
            b.write("@p%d/2\n%s\n+\n%s\n"
                    % (i, "".join("ACGTN"[c] for c in m2), "I" * 100))
    return f1p, f2p


def test_multihost_pe_shard_invariance(tmp_path, mh_pairs, db50_index3,
                                       mh_env):
    """Paired-end multihost: the record merge keeps PE spool order
    (rec_ords cover pair records) so N=2 == N=1 byte-for-byte."""
    f1, f2 = mh_pairs
    single = tmp_path / "single"
    p = _run_cli(["-ipe", str(f1), str(f2), "-t_db", db50_index3, "-o",
                  str(single)], mh_env)
    _, err = p.communicate(timeout=280)
    assert p.returncode == 0, err.decode()[-2000:]

    multi = tmp_path / "multi"
    port = _free_port()
    procs = [_run_cli(["-ipe", str(f1), str(f2), "-t_db", db50_index3,
                       "-o", str(multi), "-mh",
                       "127.0.0.1:%d,2,%d" % (port, pid)], mh_env)
             for pid in range(2)]
    errs = [p.communicate(timeout=280)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-2000:]

    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("single" + ext)).read_bytes() \
            == (tmp_path / ("multi" + ext)).read_bytes(), f"{ext} differs"
    import gzip
    assert gzip.open(str(single) + ".frag.gz").read() \
        == gzip.open(str(multi) + ".frag.gz").read()


def test_multihost_spltdb_db_sharding(tmp_path, mh_reads, mh_env,
                                      tmp_path_factory, db50,
                                      ref_index_bin):
    """-mh with multiple -t_db: the DB axis is distributed over the
    process group (one reference mapper per shard, lifted to hosts);
    outputs must be bit-identical to the in-process spltDB run."""
    d = tmp_path_factory.mktemp("mh_splt_db")
    from kma_tpu.io.seq import parse_fasta
    recs = list(parse_fasta(str(db50)))
    fa, fb = d / "a.fsa", d / "b.fsa"
    for path, lo, hi in ((fa, 0, 30), (fb, 20, 50)):
        with open(path, "w") as f:
            for h, codes in recs[lo:hi]:
                f.write(">%s\n%s\n"
                        % (h.decode(), "".join("ACGTN"[c] for c in codes)))
    pa, pb = str(d / "dbA"), str(d / "dbB")
    for fasta, prefix in ((fa, pa), (fb, pb)):
        subprocess.run([str(ref_index_bin), "-i", str(fasta), "-o",
                        prefix], check=True, capture_output=True)

    single = tmp_path / "single"
    p = _run_cli(["-i", str(mh_reads), "-t_db", pa, pb, "-o",
                  str(single)], mh_env)
    _, err = p.communicate(timeout=280)
    assert p.returncode == 0, err.decode()[-2000:]

    multi = tmp_path / "multi"
    port = _free_port()
    procs = [_run_cli(["-i", str(mh_reads), "-t_db", pa, pb, "-o",
                       str(multi), "-mh",
                       "127.0.0.1:%d,2,%d" % (port, pid)], mh_env)
             for pid in range(2)]
    errs = [p.communicate(timeout=280)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-2000:]

    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("single" + ext)).read_bytes() \
            == (tmp_path / ("multi" + ext)).read_bytes(), f"{ext} differs"
    import gzip
    assert gzip.open(str(single) + ".frag.gz").read() \
        == gzip.open(str(multi) + ".frag.gz").read()


@pytest.mark.parametrize("nproc", [2, 3])
def test_multihost_file_sharded_parse(tmp_path, mh_reads, db50_index3,
                                      mh_env, nproc):
    """Multi-file runs shard ownership by FILE (each rank parses only
    its own inputs; ordinals rebased from the all-gathered per-file
    survivor counts) -- outputs incl. the gzipped ones (written as
    per-rank gzip members) and the mapstat fragmentCount must stay
    bit-identical to the 1-process run."""
    import gzip

    # three distinct files so ranks own different subsets
    lines = mh_reads.read_text().splitlines()
    recs = ["\n".join(lines[i: i + 4]) for i in range(0, len(lines), 4)]
    files = []
    for j in range(3):
        p = tmp_path / ("part%d.fq" % j)
        p.write_text("\n".join(recs[j::3]) + "\n")
        files.append(str(p))
    base = ["-i"] + files + ["-t_db", db50_index3, "-matrix", "-vcf",
                             "-ef"]
    single = tmp_path / "single"
    p = _run_cli(base + ["-o", str(single)], mh_env)
    _, err = p.communicate(timeout=280)
    assert p.returncode == 0, err.decode()[-2000:]

    multi = tmp_path / "multi"
    port = _free_port()
    procs = [_run_cli(base + ["-o", str(multi), "-mh",
                              "127.0.0.1:%d,%d,%d" % (port, nproc, pid)],
                      mh_env) for pid in range(nproc)]
    errs = [p.communicate(timeout=280)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-2000:]

    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("single" + ext)).read_bytes() \
            == (tmp_path / ("multi" + ext)).read_bytes(), f"{ext} differs"
    for ext in (".frag.gz", ".mat.gz", ".vcf.gz"):
        assert gzip.open(str(single) + ext).read() \
            == gzip.open(str(multi) + ext).read(), f"{ext} differs"
    # fragmentCount in the mapstat header comes from the all-gathered
    # per-file survivor counts; command/date echo lines excluded
    def body(p):
        return [ln for ln in open(p, "rb").read().splitlines()
                if not ln.startswith((b"## command", b"## date"))]
    assert body(str(single) + ".mapstat") == body(str(multi) + ".mapstat")
    # no leaked .part exchange files
    import glob
    assert not glob.glob(str(multi) + ".mh*.part*")

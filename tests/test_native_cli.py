"""Native CLI driver parity net: native/kma_cli (the C++ host-path CLI
bin/kma execs first) must produce byte-identical artifacts to the Python
CLI on the configurations it covers, and exit 113 (fall back) on
everything else."""

import gzip
import os
import subprocess
import sys

import pytest

from tests.conftest import db50, db50_index, resfinder, ref_index_bin  # noqa
from tests.test_mt1 import sim_reads_mod  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(REPO, "native", "kma_cli")


def _ensure_cli():
    from kma_tpu.run_native import get_lib
    get_lib()   # builds libkma_run.so AND the kma_cli binary
    return os.path.exists(CLI)


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run_native(args, out):
    r = subprocess.run([CLI] + args + ["-o", out, "-t", "1", "-device",
                                       "off"],
                       capture_output=True, env=_env())
    return r.returncode


def _run_python(args, out):
    r = subprocess.run([sys.executable, "-m", "kma_tpu"] + args
                       + ["-o", out, "-t", "1", "-device", "off"],
                       capture_output=True, env=_env())
    assert r.returncode == 0, r.stderr.decode()[-2000:]


@pytest.mark.parametrize("margs", [
    ["-1t1"], [], ["-bcNano", "-bc", "0.7"], ["-mrs", "0.6"],
    ["-mem_mode"],
    ["-1t1", "-matrix", "-vcf", "-ef"], ["-vcf", "2"],
    ["-bcNano", "-bc", "0.7", "-matrix", "-vcf", "-ef"],
    ["-1t1", "-tsv"], ["-tsv", "257"],
    ["-1t1", "-ID", "0"], ["-ID", "0", "-tsv", "-ef"],
    ["-apm", "f"],
    ["-mq", "30"], ["-eq", "25", "-mi", "10"],
    ["-reward", "2", "-transition", "3", "-transversion", "4"],
    ["-gapopen", "5", "-gapextend", "2", "-localopen", "8"],
    ["-ConClave", "2"], ["-e", "0.001"], ["-xl", "150"],
    ["-mf", "7"], ["-mf", "100", "-ConClave", "2"],
    # presets + the proxi/lc machinery (kma.c:568-717, 1024-1248) --
    # round-5 native envelope: -proxi chain selection
    # (getProxiChainTemplates), soft proxi in mem_mode, -lc, -ts
    ["-ont"], ["-ill"], ["-asm"], ["-cge"], ["-mint2"], ["-mint3"],
    ["-lc"], ["-ts", "2"], ["-mct", "0.3"],
    ["-proxi", "0.8"], ["-proxi", "-0.9"],
    ["-proxi", "-0.9", "-mem_mode"], ["-1t1", "-proxi", "0.8"],
    ["-1t1", "-proxi", "-0.8", "-mem_mode"],
    ["-ont", "-mem_mode"], ["-ill", "-1t1"],
])
def test_native_cli_matches_python(tmp_path, sim_reads_mod, db50_index,
                                   margs):  # noqa: F811
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    a = str(tmp_path / "nat")
    b = str(tmp_path / "py")
    base = ["-i", str(sim_reads_mod), "-t_db", db50_index] + margs
    rc = _run_native(base, a)
    assert rc == 0
    _run_python(base, b)
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("nat" + ext)).read_bytes() \
            == (tmp_path / ("py" + ext)).read_bytes(), ext
    if "-tsv" in margs:
        assert (tmp_path / "nat.tsv").read_bytes() \
            == (tmp_path / "py.tsv").read_bytes(), ".tsv"
    gz_exts = [".frag.gz"]
    if "-matrix" in margs:
        gz_exts.append(".mat.gz")
    if "-vcf" in margs:
        gz_exts.append(".vcf.gz")
    for ext in gz_exts:
        with gzip.open(a + ext) as f1, gzip.open(b + ext) as f2:
            assert f1.read() == f2.read(), ext
    if "-ef" in margs:
        # mask the command echo + date lines (ef.c:30-46 metadata)
        def body(p):
            return [ln for ln in open(p, "rb").read().splitlines()
                    if not ln.startswith((b"## command", b"## date"))]
        assert body(a + ".mapstat") == body(b + ".mapstat")


@pytest.mark.parametrize("margs,exts", [
    (["-nc"], {".res", ".fsa"}),          # -nc kills .aln (kma.c:1019)
    (["-na"], {".res", ".fsa", ".aln"}),  # -na alone is a no-op
    (["-nc", "-na"], {".res"}),
])
def test_native_cli_nc_na_fileset(tmp_path, sim_reads_mod, db50_index,
                                  margs, exts):  # noqa: F811
    """The reference's swapped -nc/-na bits (kma.c:1018-1021) and the
    nc&2 .fsa re-open (runkma.c:244-256): the produced file set must
    match the reference binary's, native and Python alike."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    base = ["-i", str(sim_reads_mod), "-t_db", db50_index, "-1t1"] + margs
    assert _run_native(base, str(tmp_path / "nat")) == 0
    _run_python(base, str(tmp_path / "py"))
    for stem in ("nat", "py"):
        got = {e for e in (".res", ".fsa", ".aln")
               if (tmp_path / (stem + e)).exists()}
        assert got == exts, stem
    for e in sorted(exts):
        assert (tmp_path / ("nat" + e)).read_bytes() \
            == (tmp_path / ("py" + e)).read_bytes(), e


@pytest.mark.parametrize("margs", [
    ["-Sparse"],
    ["-proxi", "-1.0"],           # reference's no-op-pointer quirk
    ["-proxi", "0.8", "-sam"],    # proxi SAM rows stay Python
])
def test_native_cli_falls_back_se(tmp_path, sim_reads_mod, db50_index,
                                  margs):  # noqa: F811
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    rc = _run_native(["-i", str(sim_reads_mod), "-t_db", db50_index]
                     + margs, str(tmp_path / "x"))
    assert rc == 113


@pytest.mark.parametrize("margs", [
    ["-1t1", "-sam"], ["-sam"], ["-1t1", "-sam", "4"],
    ["-hmm", "-sam"],
    # mem-mode SAM (round 5): scan-miss + assembly rows from the
    # mapping-score path (runkma.c:910 sam wiring)
    ["-mem_mode", "-sam"], ["-mem_mode", "-sam", "4"],
    ["-mem_mode", "-sam", "2096"],
])
def test_native_cli_sam_parity(tmp_path, sim_reads_mod, db50_index,
                               margs):  # noqa: F811
    """Native -sam: stdout rows byte-identical to the Python CLI
    (samwrite, sam.c:114-211) modulo the @PG command echo."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    base = ["-i", str(sim_reads_mod), "-t_db", db50_index] + margs
    rn = subprocess.run([CLI] + base + ["-o", str(tmp_path / "nat"),
                                        "-t", "1", "-device", "off"],
                        capture_output=True, env=_env())
    assert rn.returncode == 0
    rp = subprocess.run([sys.executable, "-m", "kma_tpu"] + base
                        + ["-o", str(tmp_path / "py"), "-t", "1",
                           "-device", "off"],
                        capture_output=True, env=_env())
    assert rp.returncode == 0, rp.stderr.decode()[-2000:]

    def rows(buf):
        return [ln for ln in buf.decode().splitlines()
                if not ln.startswith("@PG")]

    assert rows(rn.stdout) == rows(rp.stdout)
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("nat" + ext)).read_bytes() \
            == (tmp_path / ("py" + ext)).read_bytes(), ext


@pytest.mark.parametrize("margs", [
    ["-1t1", "-xml"], ["-xml"], ["-hmm", "-xml"], ["-xml", "2"],
])
def test_native_cli_xml_parity(tmp_path, sim_reads_mod, db50_index,
                               margs):  # noqa: F811
    """Native -xml (KXmlSink, hitXML/newIterXML/capIterXML port): byte
    identical to the Python writer modulo the query-ID timestamp and the
    Parameters_cmd echo (both embed run metadata).  Certified at
    bench_resf scale against the reference with only its uninitialised
    reads normalised (see kma_tpu/out/xmlout.py)."""
    import re
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    base = ["-i", str(sim_reads_mod), "-t_db", db50_index] + margs
    rn = subprocess.run([CLI] + base + ["-o", str(tmp_path / "nat"),
                                        "-t", "1", "-device", "off"],
                        capture_output=True, env=_env())
    assert rn.returncode == 0
    rp = subprocess.run([sys.executable, "-m", "kma_tpu"] + base
                        + ["-o", str(tmp_path / "py"), "-t", "1",
                           "-device", "off"],
                        capture_output=True, env=_env())
    assert rp.returncode == 0, rp.stderr.decode()[-2000:]

    def norm(x):
        x = re.sub(rb"<BlastOutput_query-ID>kma-.*?</BlastOutput_query"
                   rb"-ID>", b"<ID>", x)
        return re.sub(rb"<Parameters_cmd>.*?</Parameters_cmd>",
                      b"<CMD>", x)

    if margs[-1] == "2":     # -xml 2 streams to stdout
        assert norm(rn.stdout) == norm(rp.stdout)
    else:
        assert norm((tmp_path / "nat.xml").read_bytes()) \
            == norm((tmp_path / "py.xml").read_bytes())
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("nat" + ext)).read_bytes() \
            == (tmp_path / ("py" + ext)).read_bytes(), ext


def test_native_cli_force_pair(tmp_path, db50_index, ref_bin):
    """-apm f (save_kmers_forcePair + alnFragsForcePE incl. the arc
    in-place flip machine) is byte-identical to the reference."""
    import numpy as np
    from kma_tpu.io.seq import parse_fasta
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    rng = np.random.default_rng(31)
    recs = [r for r in parse_fasta(
        str(tmp_path / "nope")) ] if False else None
    # pairs sampled from the db50 fasta via seq2fasta of the index
    import subprocess as sp
    fa = tmp_path / "db.fsa"
    r = sp.run([sys.executable, "-m", "kma_tpu", "seq2fasta", "-t_db",
                db50_index], capture_output=True, env=_env())
    fa.write_bytes(r.stdout)
    seqs = []
    cur = []
    for ln in fa.read_text().splitlines():
        if ln.startswith(">"):
            if cur:
                seqs.append("".join(cur))
            cur = []
        else:
            cur.append(ln)
    if cur:
        seqs.append("".join(cur))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    pe1 = tmp_path / "p1.fq"
    pe2 = tmp_path / "p2.fq"
    with open(pe1, "w") as f1, open(pe2, "w") as f2:
        n = 0
        while n < 300:
            s = seqs[int(rng.integers(len(seqs)))]
            if len(s) < 220:
                continue
            st = int(rng.integers(0, len(s) - 205))
            frag = s[st:st + 205]
            r1 = list(frag[:100])
            r2 = [comp[c] for c in frag[-100:][::-1]]
            for r_ in (r1, r2):
                for _ in range(int(rng.integers(0, 4))):
                    p = int(rng.integers(0, 100))
                    r_[p] = "ACGT"[int(rng.integers(0, 4))]
            if rng.random() < 0.5:
                r1, r2 = r2, r1   # swapped orientation: arc pairs
            f1.write("@q%d/1\n%s\n+\n%s\n" % (n, "".join(r1), "I" * 100))
            f2.write("@q%d/2\n%s\n+\n%s\n" % (n, "".join(r2), "I" * 100))
            n += 1
    ref_out = str(tmp_path / "ref")
    nat_out = str(tmp_path / "nat")
    r = sp.run([str(ref_bin), "-ipe", str(pe1), str(pe2), "-t_db",
                db50_index, "-o", ref_out, "-apm", "f", "-t", "1"],
               capture_output=True)
    assert r.returncode == 0
    rc = _run_native(["-ipe", str(pe1), str(pe2), "-t_db", db50_index,
                      "-apm", "f"], nat_out)
    assert rc == 0
    for ext in (".res", ".fsa", ".aln"):
        assert open(nat_out + ext, "rb").read() \
            == open(ref_out + ext, "rb").read(), ext
    with gzip.open(nat_out + ".frag.gz") as f1_, \
            gzip.open(ref_out + ".frag.gz") as f2_:
        assert f1_.read() == f2_.read(), ".frag.gz"


@pytest.mark.parametrize("margs", [
    ["-apm", "u", "-sam"], ["-apm", "p", "-sam"], ["-apm", "f", "-sam"],
    ["-apm", "p", "-sam", "4"], ["-apm", "p", "-sam", "2096"],
])
def test_native_cli_pe_sam_parity(tmp_path, db50_index, margs):
    """PE -sam in the native CLI (round 5): scan-phase unmapped flag
    composition (savekmers.c:205-247), step-3 unmapped rows
    (alnfrags.c PE return codes) and assembly rows.  The reference's PE
    SAM row ORDER is thread-nondeterministic, so parity is the row
    MULTISET (the bar test_pe_unmapped_sam_parity uses vs the
    reference); .res stays byte-identical."""
    from tests.test_flags import messy_pairs  # noqa: F401
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    # build messy pairs inline (same recipe as test_flags.messy_pairs
    # but self-contained to avoid fixture scoping)
    import numpy as np
    rng = np.random.default_rng(77)

    def junk(n):
        return "".join("ACGT"[c] for c in rng.integers(0, 4, n))

    from kma_tpu.index.format import load_index
    idx = load_index(db50_index)
    f1p, f2p = tmp_path / "m1.fq", tmp_path / "m2.fq"
    from kma_tpu.pipeline import TemplateStore
    store = TemplateStore(db50_index + ".seq.b",
                          np.asarray(idx.template_lengths), idx.kmersize)
    with open(f1p, "w") as f1, open(f2p, "w") as f2:
        for i in range(120):
            t = 1 + i % (idx.db_size - 1)
            codes = store.get(t).codes
            if len(codes) < 240:
                continue
            s1 = "".join("ACGTN"[c] for c in codes[:100])
            s2r = codes[140:240][::-1]
            s2 = "".join("ACGTN"[3 - c if c < 4 else c] for c in s2r)
            r = i % 6
            if r == 0:
                s1 = junk(100)
            elif r == 1:
                s2 = junk(100)
            elif r == 2:
                s1, s2 = junk(100), junk(100)
            elif r == 3:
                s1 = s1[:8]
            f1.write("@p%d/1\n%s\n+\n%s\n" % (i, s1, "I" * len(s1)))
            f2.write("@p%d/2\n%s\n+\n%s\n" % (i, s2, "I" * len(s2)))
    base = ["-ipe", str(f1p), str(f2p), "-t_db", db50_index] + margs
    a = str(tmp_path / "nat")
    b = str(tmp_path / "py")
    rn = subprocess.run([CLI] + base + ["-o", a, "-t", "1", "-device",
                                        "off"],
                        capture_output=True, env=_env())
    assert rn.returncode == 0, rn.stderr.decode()[-500:]
    rp = subprocess.run([sys.executable, "-m", "kma_tpu"] + base
                        + ["-o", b, "-t", "1", "-device", "off"],
                        capture_output=True, env=_env())
    assert rp.returncode == 0, rp.stderr.decode()[-500:]

    def rows(out):
        lines = out.split(b"\n")
        hdr = sorted(x for x in lines
                     if x.startswith(b"@") and not x.startswith(b"@PG"))
        rws = sorted(x for x in lines if x and not x.startswith(b"@"))
        return hdr, rws
    assert rows(rn.stdout) == rows(rp.stdout)
    assert (tmp_path / "nat.res").read_bytes() \
        == (tmp_path / "py.res").read_bytes()


def test_native_cli_multiple_ipe(tmp_path, db50_index):
    """Multiple -ipe pairs (runinput.c:463-607): both the even-run form
    (-ipe a b c d) and repeated flags, byte parity with the Python CLI
    and continuous read ordinals across pairs."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    import numpy as np
    from kma_tpu.index.format import load_index
    from kma_tpu.pipeline import TemplateStore
    idx = load_index(db50_index)
    store = TemplateStore(db50_index + ".seq.b",
                          np.asarray(idx.template_lengths), idx.kmersize)
    pairs = []
    for g in range(2):
        f1p, f2p = tmp_path / ("g%d_1.fq" % g), tmp_path / ("g%d_2.fq" % g)
        with open(f1p, "w") as f1, open(f2p, "w") as f2:
            for i in range(40):
                t = 1 + (g * 40 + i) % (idx.db_size - 1)
                codes = store.get(t).codes
                if len(codes) < 240:
                    continue
                s1 = "".join("ACGTN"[c] for c in codes[:100])
                s2r = codes[140:240][::-1]
                s2 = "".join("ACGTN"[3 - c if c < 4 else c] for c in s2r)
                f1.write("@g%dp%d/1\n%s\n+\n%s\n" % (g, i, s1, "I" * 100))
                f2.write("@g%dp%d/2\n%s\n+\n%s\n" % (g, i, s2, "I" * 100))
        pairs += [str(f1p), str(f2p)]
    for form in (["-ipe"] + pairs,
                 ["-ipe"] + pairs[:2] + ["-ipe"] + pairs[2:]):
        base = form + ["-t_db", db50_index, "-apm", "p"]
        a = str(tmp_path / "nat")
        b = str(tmp_path / "py")
        assert _run_native(base, a) == 0
        _run_python(base, b)
        for ext in (".res", ".fsa", ".aln"):
            assert (tmp_path / ("nat" + ext)).read_bytes() \
                == (tmp_path / ("py" + ext)).read_bytes(), ext
        with gzip.open(a + ".frag.gz") as f1_, gzip.open(b + ".frag.gz") \
                as f2_:
            assert f1_.read() == f2_.read()


@pytest.mark.parametrize("margs", [["-1t1"], [], ["-apm", "p"],
                                   ["-mem_mode"]])
def test_native_cli_mixed_se_pe(tmp_path, db50_index, sim_reads_mod,
                                ref_bin, margs):  # noqa: F811
    """Mixed SE+PE in one run (round 5): the reference streams the -i
    files first, then the -ipe pairs, with continuous fragment ordinals
    (kma.c:1559-1567); the native CLI now does the same instead of
    falling back.  Byte parity vs BOTH the Python CLI and the reference
    binary at -t 1."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    import numpy as np
    from kma_tpu.index.format import load_index
    from kma_tpu.pipeline import TemplateStore
    idx = load_index(db50_index)
    store = TemplateStore(db50_index + ".seq.b",
                          np.asarray(idx.template_lengths), idx.kmersize)
    f1p, f2p = tmp_path / "p1.fq", tmp_path / "p2.fq"
    with open(f1p, "w") as f1, open(f2p, "w") as f2:
        for i in range(60):
            t = 1 + i % (idx.db_size - 1)
            codes = store.get(t).codes
            if len(codes) < 240:
                continue
            s1 = "".join("ACGTN"[c] for c in codes[:100])
            s2r = codes[140:240][::-1]
            s2 = "".join("ACGTN"[3 - c if c < 4 else c] for c in s2r)
            f1.write("@x%d/1\n%s\n+\n%s\n" % (i, s1, "I" * 100))
            f2.write("@x%d/2\n%s\n+\n%s\n" % (i, s2, "I" * 100))
    base = ["-i", str(sim_reads_mod), "-ipe", str(f1p), str(f2p),
            "-t_db", db50_index] + margs
    a = str(tmp_path / "nat")
    b = str(tmp_path / "py")
    c = str(tmp_path / "ref")
    assert _run_native(base, a) == 0
    _run_python(base, b)
    r = subprocess.run([str(ref_bin)] + base + ["-o", c, "-t", "1"],
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    for ext in (".res", ".fsa", ".aln"):
        na = (tmp_path / ("nat" + ext)).read_bytes()
        assert na == (tmp_path / ("py" + ext)).read_bytes(), ext
        assert na == (tmp_path / ("ref" + ext)).read_bytes(), ext
    with gzip.open(a + ".frag.gz") as fa, gzip.open(b + ".frag.gz") as fb, \
            gzip.open(c + ".frag.gz") as fc:
        ba = fa.read()
        assert ba == fb.read()
        assert ba == fc.read()


@pytest.mark.parametrize("margs", [["-hmm"], ["-hmm", "-apm", "p"],
                                   ["-hmm", "-mem_mode"]])
def test_native_cli_pe_hmm(tmp_path, db50_index, ref_bin, margs):
    """PE + -hmm natively (round 5): pairs keep the pair combiners while
    single survivors use kmerScan = save_kmers_HMM (savekmers.c:129-137);
    byte parity vs the reference incl. frag.gz."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    import numpy as np
    from kma_tpu.index.format import load_index
    from kma_tpu.pipeline import TemplateStore
    idx = load_index(db50_index)
    store = TemplateStore(db50_index + ".seq.b",
                          np.asarray(idx.template_lengths), idx.kmersize)
    rng = np.random.default_rng(41)
    f1p, f2p = tmp_path / "h1.fq", tmp_path / "h2.fq"
    with open(f1p, "w") as f1, open(f2p, "w") as f2:
        for i in range(100):
            t = 1 + i % (idx.db_size - 1)
            codes = store.get(t).codes
            if len(codes) < 260:
                continue
            m1 = codes[:120].copy()
            m2 = codes[140:260][::-1]
            m2 = np.array([3 - c if c < 4 else c for c in m2], np.uint8)
            for m in (m1, m2):
                ne = rng.binomial(len(m), 0.03)
                pos = rng.integers(0, len(m), ne)
                m[pos] = (m[pos] + rng.integers(1, 4, ne)) % 4
            s1 = "".join("ACGTN"[c] for c in m1)
            s2 = "".join("ACGTN"[c] for c in m2)
            if i % 5 == 3:
                s1 = s1[:8]   # dead mate -> survivor runs the HMM scan
            if i % 5 == 4:
                s2 = s2[:8]
            f1.write("@h%d/1\n%s\n+\n%s\n" % (i, s1, "I" * len(s1)))
            f2.write("@h%d/2\n%s\n+\n%s\n" % (i, s2, "I" * len(s2)))
    base = ["-ipe", str(f1p), str(f2p), "-t_db", db50_index] + margs
    a, b = str(tmp_path / "nat"), str(tmp_path / "ref")
    assert _run_native(base, a) == 0
    r = subprocess.run([str(ref_bin)] + base + ["-o", b, "-t", "1"],
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("nat" + ext)).read_bytes() \
            == (tmp_path / ("ref" + ext)).read_bytes(), ext
    with gzip.open(a + ".frag.gz") as fa, gzip.open(b + ".frag.gz") as fb:
        assert fa.read() == fb.read()


@pytest.fixture(scope="module")
def wrap_reads(tmp_path_factory, db50_index):
    """Reads spanning the template ORIGIN (circular wrap) + reads with
    long unmatched prefixes overhanging template starts -- the shapes
    that exercise chainSeeds_circular (chain.c:262-494), the NW wrap
    (nw.c:362-368) and the free-end-clip score bounds."""
    import numpy as np
    from kma_tpu.index.format import load_index
    from kma_tpu.pipeline import TemplateStore
    idx = load_index(db50_index)
    store = TemplateStore(db50_index + ".seq.b",
                          np.asarray(idx.template_lengths), idx.kmersize)
    rng = np.random.default_rng(61)
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    out = tmp_path_factory.mktemp("wrap") / "reads.fq"
    with open(out, "w") as f:
        n = 0
        for i in range(600):
            t = 1 + i % (idx.db_size - 1)
            codes = store.get(t).codes
            if len(codes) < 220:
                continue
            if i % 2:
                off = int(rng.integers(10, 90))
                r = np.concatenate([codes[-off:],
                                    codes[:100 - off]]).copy()
            else:
                r = np.concatenate([rng.integers(0, 4, 40).astype(
                    np.uint8), codes[:60]]).copy()
            ne = rng.binomial(100, 0.02)
            pos = rng.integers(0, 100, ne)
            r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write("@w%d\n%s\n+\n%s\n"
                    % (n, "".join("ACGTN"[c] for c in r), "I" * 100))
            n += 1
    return out


@pytest.mark.parametrize("margs", [["-ca", "-1t1"], ["-ca"],
                                   ["-ca", "-mem_mode"], ["-1t1"]])
def test_native_cli_circular(tmp_path, wrap_reads, db50_index, ref_bin,
                             margs):
    """-ca joins the native envelope (round 5): circular step-3 chaining
    (chainSeeds_circular) with wrap-aware stitch and sound free-end-clip
    score bounds.  The plain -1t1 row regression-tests the bound fix on
    start-overhang reads (lead windows at t_s == 0 run NW with k == -2,
    whose free clip the old bound under-counted -- a latent unsound skip
    in linear mode too).  Byte parity vs the reference."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    base = ["-i", str(wrap_reads), "-t_db", db50_index] + margs
    a, b = str(tmp_path / "nat"), str(tmp_path / "ref")
    assert _run_native(base, a) == 0
    r = subprocess.run([str(ref_bin)] + base + ["-o", b, "-t", "1"],
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("nat" + ext)).read_bytes() \
            == (tmp_path / ("ref" + ext)).read_bytes(), ext
    with gzip.open(a + ".frag.gz") as fa, gzip.open(b + ".frag.gz") as fb:
        assert fa.read() == fb.read()
    # the Python CLI takes the same batched native scorers
    c = str(tmp_path / "py")
    _run_python(base, c)
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("py" + ext)).read_bytes() \
            == (tmp_path / ("ref" + ext)).read_bytes(), "py" + ext


@pytest.mark.parametrize("margs", [["-apm", "p"], ["-1t1"],
                                   ["-mem_mode"], []])
def test_native_cli_interleaved(tmp_path, db50_index, ref_bin, margs):
    """-int joins the native envelope (round 5): one interleaved stream,
    consecutive records pair up (run_input_INT, runinput.c:608-731) via
    an even/odd splitter feeding the shared pair consumer; the OR-loop
    semantics (runinput.c:649) run a trailing unpaired record and any
    length mismatch as singles.  Byte parity vs the reference."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    import numpy as np
    from kma_tpu.index.format import load_index
    from kma_tpu.pipeline import TemplateStore
    idx = load_index(db50_index)
    store = TemplateStore(db50_index + ".seq.b",
                          np.asarray(idx.template_lengths), idx.kmersize)
    rng = np.random.default_rng(53)
    intf = tmp_path / "il.fq"
    with open(intf, "w") as f:
        n = 0
        for i in range(80):
            t = 1 + i % (idx.db_size - 1)
            codes = store.get(t).codes
            if len(codes) < 260:
                continue
            m1 = codes[:110].copy()
            m2 = codes[150:260][::-1]
            m2 = np.array([3 - c if c < 4 else c for c in m2], np.uint8)
            for m in (m1, m2):
                ne = rng.binomial(len(m), 0.02)
                pos = rng.integers(0, len(m), ne)
                m[pos] = (m[pos] + rng.integers(1, 4, ne)) % 4
            s1 = "".join("ACGTN"[c] for c in m1)
            s2 = "".join("ACGTN"[c] for c in m2)
            if i % 7 == 3:
                s1 = s1[:6]          # failed mate
            f.write("@il%d/1\n%s\n+\n%s\n" % (i, s1, "I" * len(s1)))
            f.write("@il%d/2\n%s\n+\n%s\n" % (i, s2, "I" * len(s2)))
            n += 1
        # trailing unpaired record (OR-loop single)
        f.write("@iltail\n%s\n+\n%s\n" % (s1, "I" * len(s1)))
    base = ["-int", str(intf), "-t_db", db50_index] + margs
    a, b = str(tmp_path / "nat"), str(tmp_path / "ref")
    assert _run_native(base, a) == 0
    r = subprocess.run([str(ref_bin)] + base + ["-o", b, "-t", "1"],
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("nat" + ext)).read_bytes() \
            == (tmp_path / ("ref" + ext)).read_bytes(), ext
    with gzip.open(a + ".frag.gz") as fa, gzip.open(b + ".frag.gz") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("margs", [["-asm"], ["-1t1"], [],
                                   ["-mem_mode"], ["-hmm"]])
def test_native_cli_fasta_input(tmp_path, db50_index, ref_bin, margs):
    """Fasta query input joins the native envelope (round 5):
    kio_parse_fasta implements FileBuffgetFsa + fsastat semantics
    (seqparse.c:66-159, runinput.c:315-368) -- edge-N trimming, the
    max_len raw-length reject, multi-line records, and the internal-Ns
    min_len gate.  The -asm preset (the reference's advertised
    assembly-mapping mode) rides it.  Byte parity vs the reference.
    All-N records are excluded: the reference's fsastat underflows its
    buffer and segfaults on them (we handle them gracefully)."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    import numpy as np
    from kma_tpu.index.format import load_index
    from kma_tpu.pipeline import TemplateStore
    idx = load_index(db50_index)
    store = TemplateStore(db50_index + ".seq.b",
                          np.asarray(idx.template_lengths), idx.kmersize)
    rng = np.random.default_rng(67)
    fasta = tmp_path / "contigs.fsa"
    with open(fasta, "w") as f:
        f.write(">short\nACGT\n")
        for i in range(60):
            t = 1 + i % (idx.db_size - 1)
            codes = store.get(t).codes.copy()
            ne = rng.binomial(len(codes), 0.005)
            pos = rng.integers(0, len(codes), ne)
            codes[pos] = (codes[pos] + rng.integers(1, 4, ne)) % 4
            seq = "".join("ACGTN"[c] for c in codes)
            if i % 5 == 0:
                seq = "N" * 12 + seq + "NN"   # edge-N trim
            if i % 7 == 0:                     # multi-line record
                seq = "\n".join(seq[j: j + 61] for j in range(0, len(seq),
                                                              61))
            f.write(">c%d\n%s\n" % (i, seq))
    base = ["-i", str(fasta), "-t_db", db50_index] + margs
    a, b = str(tmp_path / "nat"), str(tmp_path / "ref")
    assert _run_native(base, a) == 0
    r = subprocess.run([str(ref_bin)] + base + ["-o", b, "-t", "1"],
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("nat" + ext)).read_bytes() \
            == (tmp_path / ("ref" + ext)).read_bytes(), ext
    with gzip.open(a + ".frag.gz") as fa, gzip.open(b + ".frag.gz") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("margs", [
    ["-proxi", "0.8"], ["-proxi", "-0.9"],
    ["-proxi", "0.6", "-mem_mode"], ["-proxi", "-0.9", "-mem_mode"],
    # penalty / force proxi combiners (getSecondProxiPen/Force incl.
    # the Force variant's stale-tail region quirk, savekmers.c:1350)
    ["-proxi", "0.8", "-apm", "p"], ["-proxi", "-0.8", "-apm", "p"],
    ["-proxi", "0.8", "-apm", "f"], ["-proxi", "-0.7", "-apm", "f"],
])
def test_native_cli_pe_proxi(tmp_path, db50_index, ref_bin, margs):
    """PE + -proxi (union pairing) natively (round 5): getF_Proxi /
    getR_Proxi (savekmers.c:1764-1923) incl. soft accumulation; byte
    parity vs the reference."""
    if not _ensure_cli():
        pytest.skip("native CLI unavailable")
    import numpy as np
    from kma_tpu.index.format import load_index
    from kma_tpu.pipeline import TemplateStore
    idx = load_index(db50_index)
    store = TemplateStore(db50_index + ".seq.b",
                          np.asarray(idx.template_lengths), idx.kmersize)
    rng = np.random.default_rng(71)
    f1p, f2p = tmp_path / "q1.fq", tmp_path / "q2.fq"
    with open(f1p, "w") as f1, open(f2p, "w") as f2:
        for i in range(120):
            t = 1 + i % (idx.db_size - 1)
            codes = store.get(t).codes
            if len(codes) < 260:
                continue
            m1 = codes[:110].copy()
            m2 = codes[150:260][::-1]
            m2 = np.array([3 - c if c < 4 else c for c in m2], np.uint8)
            for m in (m1, m2):
                ne = rng.binomial(len(m), 0.04)
                pos = rng.integers(0, len(m), ne)
                m[pos] = (m[pos] + rng.integers(1, 4, ne)) % 4
            s1 = "".join("ACGTN"[c] for c in m1)
            s2 = "".join("ACGTN"[c] for c in m2)
            if i % 6 == 3:
                s1 = s1[:6]
            if i % 6 == 4:
                s2 = s2[:6]
            f1.write("@q%d/1\n%s\n+\n%s\n" % (i, s1, "I" * len(s1)))
            f2.write("@q%d/2\n%s\n+\n%s\n" % (i, s2, "I" * len(s2)))
    base = ["-ipe", str(f1p), str(f2p), "-t_db", db50_index] + margs
    a, b = str(tmp_path / "nat"), str(tmp_path / "ref")
    assert _run_native(base, a) == 0
    r = subprocess.run([str(ref_bin)] + base + ["-o", b, "-t", "1"],
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("nat" + ext)).read_bytes() \
            == (tmp_path / ("ref" + ext)).read_bytes(), ext
    with gzip.open(a + ".frag.gz") as fa, gzip.open(b + ".frag.gz") as fb:
        assert fa.read() == fb.read()

"""Test configuration.

Forces JAX onto a virtual 8-device CPU mesh so multi-device sharding logic
is exercised without accelerator hardware.  Must run before jax import.

Tests that only a GPU can run carry the ``gpu`` marker and skip here;
chip_smoke.py runs their checks on the card.
"""

import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; "
        "chip_smoke.py runs the same checks on the card)")


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided when the test runs)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py covers this on "
                    "the card")


REPO = Path(__file__).resolve().parent.parent
REF_BUILD = REPO / ".ref_build"
REF_KMA = REF_BUILD / "kma"
REF_KMA_INDEX = REF_BUILD / "kma_index"
RESFINDER = REF_BUILD / "benchmarkCMDs" / "ResFinder.fasta"


def ensure_reference() -> bool:
    """Build the reference binary (golden-test oracle) if not present."""
    if REF_KMA.exists():
        return True
    ref_src = Path("/root/reference")
    if not ref_src.exists():
        return False
    REF_BUILD.mkdir(exist_ok=True)
    for f in ref_src.glob("*.[ch]"):
        (REF_BUILD / f.name).write_bytes(f.read_bytes())
    (REF_BUILD / "Makefile").write_bytes((ref_src / "Makefile").read_bytes())
    subprocess.run(["make", "-j8"], cwd=REF_BUILD, check=True,
                   capture_output=True)
    subprocess.run(["tar", "xzf", str(ref_src / "performanceAndComparisonCMDs.tar.gz")],
                   cwd=REF_BUILD, check=True)
    return REF_KMA.exists()


@pytest.fixture(scope="session")
def ref_bin():
    if not ensure_reference():
        pytest.skip("reference binary not available")
    return REF_KMA


@pytest.fixture(scope="session")
def ref_index_bin(ref_bin):
    return REF_KMA_INDEX


@pytest.fixture(scope="session")
def resfinder(ref_bin):
    return RESFINDER


@pytest.fixture(scope="session")
def bench_resf_prefix(resfinder):
    """Full ResFinder index at testdata/bench_resf (shared with bench.py);
    built on demand so a fresh checkout doesn't depend on leftovers."""
    import pathlib
    prefix = pathlib.Path("testdata") / "bench_resf"
    if not prefix.with_suffix(".comp.b").exists():
        prefix.parent.mkdir(exist_ok=True)
        from kma_tpu.index.build import build_index
        build_index([str(resfinder)], str(prefix), quiet=True)
    return str(prefix)


@pytest.fixture(scope="session")
def db50(tmp_path_factory, resfinder):
    """First 50 ResFinder templates as a small test fasta."""
    out = tmp_path_factory.mktemp("db") / "db50.fsa"
    recs = 0
    lines = []
    for line in resfinder.read_text().splitlines(keepends=True):
        if line.startswith(">"):
            recs += 1
            if recs > 50:
                break
        lines.append(line)
    out.write_text("".join(lines))
    return out


def run_ref(args, **kw):
    """Run the reference kma binary."""
    return subprocess.run([str(REF_KMA)] + args, capture_output=True, **kw)


@pytest.fixture(scope="session")
def db50_index(tmp_path_factory, db50, ref_index_bin):
    d = tmp_path_factory.mktemp("db_idx_s")
    prefix = str(d / "db")
    subprocess.run([str(ref_index_bin), "-i", str(db50), "-o", prefix],
                   check=True, capture_output=True)
    return prefix


@pytest.fixture(scope="session")
def sim_reads(tmp_path_factory, db50):
    """Deterministic synthetic reads with errors from db50 templates."""
    import numpy as np
    from kma_tpu.io.seq import parse_fasta
    rng = np.random.default_rng(42)
    recs = list(parse_fasta(str(db50)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    out = tmp_path_factory.mktemp("reads_s") / "reads.fq"
    with open(out, "w") as f:
        for ri in range(500):
            _h, codes = recs[rng.integers(len(recs))]
            L = int(rng.integers(80, 150))
            if len(codes) <= L:
                continue
            s = int(rng.integers(0, len(codes) - L))
            r = codes[s: s + L].copy()
            nerr = rng.binomial(L, 0.01)
            ppos = rng.integers(0, L, nerr)
            r[ppos] = (r[ppos] + rng.integers(1, 4, nerr)) % 4
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            seq = "".join("ACGTN"[c] for c in r)
            f.write(f"@r{ri}\n{seq}\n+\n{'I' * len(seq)}\n")
    return out


@pytest.fixture(scope="session")
def sim_pairs(tmp_path_factory, db50):
    """Proper pairs (insert 205) plus orientation flips and errors."""
    import numpy as np
    from kma_tpu.io.seq import parse_fasta
    rng = np.random.default_rng(99)
    recs = list(parse_fasta(str(db50)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    d = tmp_path_factory.mktemp("pe_s")
    f1p, f2p = d / "pe_1.fq", d / "pe_2.fq"
    with open(f1p, "w") as f1, open(f2p, "w") as f2:
        n = 0
        while n < 300:
            _h, codes = recs[rng.integers(len(recs))]
            ins, L = 205, 100
            if len(codes) <= ins + 2:
                continue
            s = int(rng.integers(0, len(codes) - ins))
            frag = codes[s: s + ins]
            r1 = frag[:L].copy()
            r2 = comp[frag[-L:][::-1]].copy()
            for r in (r1, r2):
                ne = rng.binomial(L, 0.01)
                pos = rng.integers(0, L, ne)
                r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            if rng.random() < 0.5:
                r1, r2 = comp[r2[::-1]].copy(), comp[r1[::-1]].copy()
            f1.write(f"@p{n}/1\n{''.join('ACGTN'[c] for c in r1)}\n"
                     f"+\n{'I' * L}\n")
            f2.write(f"@p{n}/2\n{''.join('ACGTN'[c] for c in r2)}\n"
                     f"+\n{'I' * L}\n")
            n += 1
    return f1p, f2p


@pytest.fixture(scope="session")
def panel(tmp_path_factory):
    """Seeded test-sized gene panel (kma_tpu.utils.simdata.SMALL): the
    indexed panel and its SE, PE and Nanopore read sets."""
    from kma_tpu.utils import simdata
    d = tmp_path_factory.mktemp("panel")
    return simdata.generate(str(d), seed=1, sizes=simdata.SMALL, index=True)


@pytest.fixture(scope="session")
def long_panel(tmp_path_factory):
    """200 templates at the panel's widths (600-2,400 bp) and 300
    Nanopore reads of 1-20 kb: enough long reads that some candidates
    carry the heavy lead/trail windows of the step-3 NW pre-pass."""
    import dataclasses

    from kma_tpu.utils import simdata
    d = tmp_path_factory.mktemp("long_panel")
    sizes = dataclasses.replace(simdata.Sizes(), families=40, templates=200,
                                se=0, pe=0, ont=300)
    return simdata.generate(str(d), seed=1, sizes=sizes, index=True)


def run_pair(tmp_path, args, name="run", env=None):
    """Run ``python -m kma_tpu args`` with -device on and -device off and
    assert byte-equal outputs; returns the -device on stderr."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    errs = {}
    for dev in ("on", "off"):
        r = subprocess.run([sys.executable, "-m", "kma_tpu", *args, "-o",
                            str(tmp_path / (name + dev)), "-device", dev],
                           capture_output=True, env=env)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        errs[dev] = r.stderr.decode()
    import gzip
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / (name + "on" + ext)).read_bytes() \
            == (tmp_path / (name + "off" + ext)).read_bytes(), ext
    assert gzip.open(str(tmp_path / (name + "on.frag.gz"))).read() \
        == gzip.open(str(tmp_path / (name + "off.frag.gz"))).read()
    return errs["on"]


def pytest_sessionstart(session):
    """Precompile the package once: PYTHONDONTWRITEBYTECODE in this
    environment otherwise costs ~2.5 s of re-compilation per spawned
    python (tests fork many)."""
    import compileall
    import sys as _sys
    _sys.dont_write_bytecode = False
    compileall.compile_dir(str(REPO / "kma_tpu"), quiet=2)

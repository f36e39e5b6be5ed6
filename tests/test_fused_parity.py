"""Fused-driver parity net: the native run driver (KMA_TPU_NO_FUSED
unset) must produce byte-identical outputs to the per-component pipeline
(KMA_TPU_NO_FUSED=1) across the modes it covers."""

import gzip
import os
import subprocess
import sys

import pytest

from tests.conftest import db50, db50_index, resfinder, ref_index_bin  # noqa
from tests.test_mt1 import sim_reads_mod  # noqa: F401


def _run(args, out, fused):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    if not fused:
        env["KMA_TPU_NO_FUSED"] = "1"
    r = subprocess.run([sys.executable, "-m", "kma_tpu"] + args
                       + ["-o", out, "-t", "1", "-device", "off"],
                       capture_output=True, env=env)
    assert r.returncode == 0, r.stderr.decode()[-2000:]


@pytest.mark.parametrize("margs", [
    ["-1t1"], [], ["-mem_mode"], ["-1t1", "-a"], ["-mf", "7"],
    ["-ConClave", "2"], ["-ef"], ["-matrix"],
])
def test_fused_matches_unfused(tmp_path, sim_reads_mod, db50_index,
                               margs):  # noqa: F811
    a = str(tmp_path / "fused")
    b = str(tmp_path / "plain")
    base = ["-i", str(sim_reads_mod), "-t_db", db50_index] + margs
    _run(base, a, fused=True)
    _run(base, b, fused=False)
    for ext in (".res", ".fsa", ".aln"):
        assert (tmp_path / ("fused" + ext)).read_bytes() \
            == (tmp_path / ("plain" + ext)).read_bytes(), ext
    assert gzip.open(a + ".frag.gz").read() \
        == gzip.open(b + ".frag.gz").read()
    if "-a" in margs:
        assert gzip.open(a + ".frag_raw.gz").read() \
            == gzip.open(b + ".frag_raw.gz").read()
    if "-ef" in margs:
        sa = (tmp_path / "fused.mapstat").read_text().splitlines()
        sb = (tmp_path / "plain.mapstat").read_text().splitlines()
        # the command line in the header differs (env only); rows must not
        assert [l for l in sa if not l.startswith("##")] \
            == [l for l in sb if not l.startswith("##")]
    if "-matrix" in margs:
        assert gzip.open(a + ".mat.gz").read() \
            == gzip.open(b + ".mat.gz").read()

"""Device step-3 pre-pass (align/nw_device.py): -device on, byte parity.

The batched step-3 scorer exports heavy lead/trail banded windows and
feeds device NW scores into phase B's skip rules (kma_align.cpp
kaln_se_windows / kaln_set_dev_scores).  The skip rules are
output-neutral, so a -device on run, which scores every exported window
on the device, must be byte-identical to the host run; on the CPU the
plain jax.numpy scorer stands in for the GPU kernel.
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kma_tpu.cli.main import index_main, main


@pytest.fixture(scope="module")
def prepass_db(tmp_path_factory):
    """Templates + reads shaped to trigger the pre-pass: long unmatched
    prefixes make lead windows past the 32k-cell threshold."""
    d = tmp_path_factory.mktemp("nwpre")
    rng = np.random.default_rng(42)
    seqs = []
    base = rng.integers(0, 4, 800)
    fasta = d / "db.fsa"
    with open(fasta, "w") as f:
        for t in range(4):
            codes = base.copy()
            # alleles: a few scattered SNPs keep windows content-distinct
            pos = rng.integers(0, 800, 6 + 3 * t)
            codes[pos] = (codes[pos] + 1 + t) % 4
            seqs.append(codes)
            f.write(">tpl%d\n%s\n"
                    % (t, "".join("ACGT"[c] for c in codes)))
    prefix = str(d / "db")
    assert index_main(["-i", str(fasta), "-o", prefix]) == 0
    reads = d / "reads.fq"
    with open(reads, "w") as f:
        for i in range(6):
            t = seqs[i % 4]
            # 300bp mutated prefix (no seeds) + 200bp faithful match:
            # the chain starts ~300 into the read -> lead window
            # ~300x128 cells > the 32k pre-pass trigger
            pre = t[100:400].copy()
            ne = 90
            pos = rng.integers(0, 300, ne)
            pre[pos] = (pre[pos] + rng.integers(1, 4, ne)) % 4
            body = t[400:600]
            r = np.concatenate([pre, body])
            s = "".join("ACGT"[c] for c in r)
            f.write("@r%d\n%s\n+\n%s\n" % (i, s, "I" * len(s)))
    return prefix, str(reads)


def test_forced_device_prepass_parity(prepass_db, tmp_path):
    prefix, reads = prepass_db
    out_host = str(tmp_path / "host")
    out_dev = str(tmp_path / "dev")
    assert main(["-i", reads, "-t_db", prefix, "-o", out_host,
                 "-1t1", "-device", "off"]) in (0, None)
    from kma_tpu.align import nw_device
    nw_device.LAST_STATS["windows"] = 0
    assert main(["-i", reads, "-t_db", prefix, "-o", out_dev,
                 "-1t1", "-device", "on"]) in (0, None)
    assert nw_device.LAST_STATS["windows"] > 0, \
        "device pre-pass never engaged"
    for ext in (".res", ".fsa", ".aln"):
        a = Path(out_host + ext).read_bytes()
        b = Path(out_dev + ext).read_bytes()
        assert a == b, ext
    import gzip
    a = gzip.open(out_host + ".frag.gz").read()
    b = gzip.open(out_dev + ".frag.gz").read()
    assert a == b, ".frag.gz content"

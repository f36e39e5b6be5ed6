"""Device-path e2e parity on seeded gene-panel data: full mapping runs
with ``-device on`` must be byte-identical to the ``-device off`` host
run.  On the CPU test backend ``-device on`` runs the same device code
through XLA's CPU backend (the plain kernel versions); on the GPU
chip_smoke.py runs the same comparisons at real size."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from tests.conftest import REPO, run_pair


def test_device_1t1_parity(tmp_path, panel):
    err = run_pair(tmp_path, ["-i", panel["se"], "-t_db", panel["db"],
                              "-1t1"])
    assert "scan_batches=" in err and "scan_batches=0" not in err


def test_device_1t1_parity_threaded(tmp_path, panel):
    """-t 4: the threaded native batch aligner must stay byte-identical
    (per-read output slots make worker scheduling invisible)."""
    run_pair(tmp_path, ["-i", panel["se"], "-t_db", panel["db"], "-1t1",
                        "-t", "4"])


def test_device_chain_mode_parity(tmp_path, panel):
    """Default (chain) mode with the device on."""
    run_pair(tmp_path, ["-i", panel["se"], "-t_db", panel["db"]])


def test_device_chain_long_reads(tmp_path, panel):
    """Nanopore-length reads (-bcNano -bc 0.7): no read-length ceiling."""
    run_pair(tmp_path, ["-i", panel["ont"], "-t_db", panel["db"],
                        "-bcNano", "-bc", "0.7"])


def test_device_nw_prepass_ont(tmp_path, long_panel):
    """Nanopore reads (-bcNano -bc 0.7, per-component pipeline) engage
    the step-3 NW pre-pass on the device under -device on,
    byte-identical to the host pre-pass."""
    err = run_pair(tmp_path, ["-i", long_panel["ont"], "-t_db",
                              long_panel["db"], "-bcNano", "-bc", "0.7"],
                   env=dict(os.environ, KMA_TPU_NO_FUSED="1",
                            KMA_ALN_PROF="1"))
    assert "nw_windows=0" not in err and "nw_windows=" in err
    assert "predev 0 " not in err and "predev " in err


def test_device_on_refuses_unsupported_db(tmp_path, panel):
    """-device on against a database the device scanner cannot take (a
    minimizer index) ends the run non-zero with the reason; -device
    auto keeps the host scan."""
    db = str(tmp_path / "mdb")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-m", "kma_tpu", "index", "-i",
                    panel["fasta"], "-o", db, "-m", "14"], check=True,
                   capture_output=True, env=env)
    base = [sys.executable, "-m", "kma_tpu", "-i", panel["se"], "-t_db",
            db, "-1t1", "-o", str(tmp_path / "o")]
    r = subprocess.run(base + ["-device", "on"], capture_output=True,
                       env=env)
    assert r.returncode != 0
    assert b"cannot run on the device" in r.stderr
    r = subprocess.run(base + ["-device", "auto"], capture_output=True,
                       env=dict(env, KMA_TPU_DEVICE_AUTO_MB="0"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]


def test_big_db_falls_to_pair_stream(panel, monkeypatch):
    """A DB past the dense-membership budget takes the pair-stream
    FastScanner (scan_fast.py) as the device path (kmers.c:84-125 scale
    story), with host-exact results."""
    from kma_tpu.config import Penalties
    from kma_tpu.index.format import load_index, seq_offsets
    from kma_tpu.io.pipeline import Read
    from kma_tpu.io.seq import unpack_2bit
    from kma_tpu.mapping.scan import SaveKmersScanner
    from kma_tpu.mapping.scan_fast import FastScanner
    from kma_tpu.mapping.scan_stream import DeviceScanStream

    from kma_tpu.mapping import scan_dense
    monkeypatch.setattr(scan_dense, "dense_budget_bytes", lambda: 0)
    db = panel["db"]
    idx = load_index(db)
    pen = Penalties()
    pen.score_matrix()
    host = SaveKmersScanner(idx, pen)
    stream = DeviceScanStream(idx, pen, batch=32, host=host)
    assert isinstance(stream.dense, FastScanner)

    lens = idx.template_lengths
    offs = seq_offsets(lens)
    reads = []
    with open(db + ".seq.b", "rb") as f:
        for t in range(1, 6):
            f.seek(int(offs[t]))
            words = np.fromfile(f, dtype="<u8",
                                count=(int(lens[t]) >> 5) + 1)
            codes = unpack_2bit(words, int(lens[t]))[:96].copy()
            reads.append(Read(codes, b"r%d\x00" % t))
    host2 = SaveKmersScanner(idx, pen)
    for read, hit in stream.stream(iter(reads)):
        exp = host2.scan(read.codes, read.n_positions, read.header)
        if exp is None:
            assert hit is None
            continue
        assert hit is not None
        assert int(hit.rc_flag) == int(exp.rc_flag)
        assert list(np.asarray(hit.templates)) \
            == list(np.asarray(exp.templates))

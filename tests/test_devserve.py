"""devserve daemon: protocol, parity with in-process scanners, e2e.

The persistent device session (kma_tpu/devserve.py) is the device analog
of the reference's shm residency (shm.c:51-153): scanners stay compiled
and device-resident in a daemon; runs attach over a unix socket.
"""

import gzip
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kma_tpu.cli.main import index_main, main
from kma_tpu.config import Penalties
from kma_tpu.devserve import DevClient, socket_path
from kma_tpu.index.format import load_index

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def disk_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("devserve")
    rng = np.random.default_rng(7)
    fasta = d / "db.fsa"
    seqs = []
    with open(fasta, "w") as f:
        for t in range(8):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 300))
            seqs.append(seq)
            f.write(">tpl%d\n%s\n" % (t, seq))
    prefix = str(d / "db")
    assert index_main(["-i", str(fasta), "-o", prefix]) == 0
    reads = d / "reads.fq"
    with open(reads, "w") as f:
        for i in range(60):
            s = seqs[i % 8][i % 100: i % 100 + 100]
            f.write("@r%d\n%s\n+\n%s\n" % (i, s, "I" * len(s)))
    return prefix, str(reads)


@pytest.fixture(scope="module")
def daemon(disk_db, tmp_path_factory):
    prefix, _ = disk_db
    sdir = str(tmp_path_factory.mktemp("sock"))
    env = dict(os.environ, KMA_DEVSERVE_DIR=sdir,
               KMA_DEVSERVE_EXIT_WITH=str(os.getpid()),
               KMA_DEVSERVE_FRAME_TIMEOUT="5",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kma_tpu", "devserve", "-t_db", prefix,
         "-batch", "32", "-warm", ""],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    path = None
    try:
        deadline = time.time() + 120
        cli = None
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError("daemon died rc=%s" % proc.returncode)
            os.environ["KMA_DEVSERVE_DIR"] = sdir
            cli = DevClient.connect(prefix)
            if cli is not None:
                break
            time.sleep(0.2)
        assert cli is not None, "daemon never came up"
        cli.close()
        yield prefix, sdir
    finally:
        os.environ.pop("KMA_DEVSERVE_DIR", None)
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)


def test_dense_and_chain_parity(daemon, disk_db):
    prefix, sdir = daemon
    os.environ["KMA_DEVSERVE_DIR"] = sdir
    cli = DevClient.connect(prefix)
    assert cli is not None
    idx = load_index(prefix)
    pen = Penalties()
    rng = np.random.default_rng(1)
    codes = np.full((50, 128), 4, np.uint8)
    lengths = np.full(50, 100, np.int32)
    codes[:, :100] = rng.integers(0, 4, (50, 100), dtype=np.uint8)

    s, m, t, o = cli.dense_scan(codes, lengths, pen, False, None)
    from kma_tpu.mapping.scan_dense import DenseScanner
    loc = DenseScanner(idx, pen, batch=32)
    s2, m2, t2, o2 = loc.scan_reads(codes, lengths)
    assert (s == s2).all() and (m == m2).all() and (o == o2).all()
    for a, b in zip(t, t2):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b))

    rf, rr = cli.chain_lookup(codes, lengths)
    from kma_tpu.mapping.chain_device import _chain_lookup
    d = loc.didx
    rf2, rr2 = _chain_lookup(d.exist, d.kv, codes, lengths,
                             k=idx.kmersize, mega=d.mega, size=d.size,
                             max_probe=d.max_probe)
    assert np.array_equal(rf, np.asarray(rf2))
    assert np.array_equal(rr, np.asarray(rr2))
    assert np.array_equal(cli.voff_map,
                          np.asarray(d.list_voff, np.int64))
    cli.close()


def test_nw_op(daemon):
    prefix, sdir = daemon
    os.environ["KMA_DEVSERVE_DIR"] = sdir
    cli = DevClient.connect(prefix)
    assert cli is not None
    from kma_tpu.ops.nw_kernel import stage_code_inputs
    from kma_tpu.align.nw import nw_band
    from kma_tpu.config import Penalties
    pen = Penalties()
    d = pen.score_matrix()
    rng = np.random.default_rng(3)
    B = 8
    tls, qls, ts, qs, kf = [], [], [], [], []
    for b in range(B):
        tl = int(rng.integers(20, 60))
        ql = tl + int(rng.integers(-4, 5))
        ts.append(rng.integers(0, 4, tl).astype(np.uint8))
        qs.append(rng.integers(0, 4, max(ql, 1)).astype(np.uint8))
        tls.append(tl)
        qls.append(max(ql, 1))
        kf.append([0, 1, -1, 2][b % 4])
    t_len, q_len, hb, qext, tcol = stage_code_inputs(ts, qs, tls, qls, 64)
    got = cli.nw_scores(t_len, q_len, np.asarray(kf, np.int32), hb, qext,
                        tcol, dmat=d[:5, :5], W1=pen.W1, U=pen.U,
                        MM=pen.MM)
    for b in range(B):
        exp = nw_band(ts[b], qs[b], kf[b], 0, tls[b], 0, qls[b], 64,
                      d, pen.W1, pen.U, pen.MM, tls[b])
        assert got[b] == exp.score, "cand %d" % b
    assert cli.stats().get("nw", 0) >= 1
    cli.close()


def test_e2e_device_run_via_daemon(daemon, disk_db, tmp_path):
    """-device on with a live daemon = byte parity with the host path
    (gzip members may differ in framing; compare decompressed)."""
    prefix, reads = disk_db
    _, sdir = daemon
    os.environ["KMA_DEVSERVE_DIR"] = sdir
    out_dev = str(tmp_path / "dev")
    out_host = str(tmp_path / "host")
    assert main(["-i", reads, "-t_db", prefix, "-o", out_dev, "-1t1",
                 "-device", "on"]) in (0, None)
    assert main(["-i", reads, "-t_db", prefix, "-o", out_host, "-1t1",
                 "-device", "off"]) in (0, None)
    for ext in (".res", ".fsa", ".aln"):
        a = open(out_dev + ext, "rb").read()
        b = open(out_host + ext, "rb").read()
        assert a == b, ext
    a = gzip.open(out_dev + ".frag.gz").read()
    b = gzip.open(out_host + ".frag.gz").read()
    assert a == b, ".frag.gz content"


def test_hmm_device_run_via_daemon(daemon, disk_db, tmp_path):
    """-hmm -device on probes through the daemon's chain op at byte
    parity with the host HMM scan (savekmers.c:3866-4522 flow)."""
    prefix, reads = disk_db
    _, sdir = daemon
    os.environ["KMA_DEVSERVE_DIR"] = sdir
    out_dev = str(tmp_path / "hdev")
    out_host = str(tmp_path / "hhost")
    assert main(["-i", reads, "-t_db", prefix, "-o", out_dev, "-hmm",
                 "-device", "on"]) in (0, None)
    assert main(["-i", reads, "-t_db", prefix, "-o", out_host, "-hmm",
                 "-device", "off"]) in (0, None)
    for ext in (".res", ".fsa", ".aln"):
        a = open(out_dev + ext, "rb").read()
        b = open(out_host + ext, "rb").read()
        assert a == b, ext
    a = gzip.open(out_dev + ".frag.gz").read()
    b = gzip.open(out_host + ".frag.gz").read()
    assert a == b, ".frag.gz content"


def test_native_cli_uses_daemon(daemon, disk_db, tmp_path):
    """bin/kma -device on routes the scan through the daemon from the
    NATIVE CLI (native/kma_devclient.cpp) at byte parity."""
    prefix, reads = disk_db
    _, sdir = daemon
    cli = REPO / "native" / "kma_cli"
    if not cli.exists():
        pytest.skip("native CLI not built")
    env = dict(os.environ, KMA_DEVSERVE_DIR=sdir)
    out_dev = str(tmp_path / "ndev")
    out_host = str(tmp_path / "nhost")
    r = subprocess.run(
        [str(cli), "-i", reads, "-t_db", prefix, "-o", out_dev, "-1t1",
         "-device", "on"], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "devserve session" in r.stderr
    r = subprocess.run(
        [str(cli), "-i", reads, "-t_db", prefix, "-o", out_host, "-1t1",
         "-device", "off"], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    for ext in (".res", ".fsa", ".aln", ".frag.gz"):
        a = open(out_dev + ext, "rb").read()
        b = open(out_host + ext, "rb").read()
        assert a == b, ext
    # no daemon dir -> the CLI exits 113 (python fallback owns the run)
    env2 = dict(os.environ, KMA_DEVSERVE_DIR=str(tmp_path / "empty"))
    r = subprocess.run(
        [str(cli), "-i", reads, "-t_db", prefix, "-o", out_dev, "-1t1",
         "-device", "on"], env=env2, capture_output=True, text=True)
    assert r.returncode == 113


def test_native_cli_pe_dev(daemon, disk_db, tmp_path):
    """PE -device on: both mates' window probes through the daemon's
    chain op feed the native pair combiners (krun_map_pe_batch voffs)
    at byte parity."""
    prefix, _ = disk_db
    _, sdir = daemon
    cli = REPO / "native" / "kma_cli"
    if not cli.exists():
        pytest.skip("native CLI not built")
    # pairs sampled from the DB templates
    import re
    seqs = []
    fasta = Path(prefix).parent / "db.fsa"
    cur = []
    for ln in open(fasta):
        if ln.startswith(">"):
            if cur:
                seqs.append("".join(cur))
            cur = []
        else:
            cur.append(ln.strip())
    if cur:
        seqs.append("".join(cur))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    pe1 = tmp_path / "p1.fq"
    pe2 = tmp_path / "p2.fq"
    with open(pe1, "w") as f1, open(pe2, "w") as f2:
        for i in range(40):
            s = seqs[i % len(seqs)]
            frag = s[i % 90: i % 90 + 200]
            r1 = frag[:100]
            r2 = "".join(comp[c] for c in frag[-100:][::-1])
            f1.write("@p%d/1\n%s\n+\n%s\n" % (i, r1, "I" * len(r1)))
            f2.write("@p%d/2\n%s\n+\n%s\n" % (i, r2, "I" * len(r2)))
    env = dict(os.environ, KMA_DEVSERVE_DIR=sdir)
    out_dev = str(tmp_path / "pdev")
    out_host = str(tmp_path / "phost")
    r = subprocess.run(
        [str(cli), "-ipe", str(pe1), str(pe2), "-t_db", prefix, "-o",
         out_dev, "-apm", "p", "-device", "on"],
        env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "devserve session" in r.stderr
    r = subprocess.run(
        [str(cli), "-ipe", str(pe1), str(pe2), "-t_db", prefix, "-o",
         out_host, "-apm", "p", "-device", "off"],
        env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    for ext in (".res", ".fsa", ".aln", ".frag.gz"):
        a = open(out_dev + ext, "rb").read()
        b = open(out_host + ext, "rb").read()
        assert a == b, ext


def test_native_cli_chain_dev(daemon, disk_db, tmp_path):
    """Default (chain) mode -device on: the native CLI ships the
    per-window probes through the daemon's chain op and the splicer
    consumes the voffs (krun_map_se_batch_chain_dev) at byte parity."""
    prefix, reads = disk_db
    _, sdir = daemon
    cli = REPO / "native" / "kma_cli"
    if not cli.exists():
        pytest.skip("native CLI not built")
    env = dict(os.environ, KMA_DEVSERVE_DIR=sdir)
    out_dev = str(tmp_path / "cdev")
    out_host = str(tmp_path / "chost")
    r = subprocess.run(
        [str(cli), "-i", reads, "-t_db", prefix, "-o", out_dev,
         "-device", "on"], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "devserve session" in r.stderr
    r = subprocess.run(
        [str(cli), "-i", reads, "-t_db", prefix, "-o", out_host,
         "-device", "off"], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    for ext in (".res", ".fsa", ".aln", ".frag.gz"):
        a = open(out_dev + ext, "rb").read()
        b = open(out_host + ext, "rb").read()
        assert a == b, ext


def test_native_cli_hmm_dev(daemon, disk_db, tmp_path):
    """-hmm -device on in the NATIVE CLI: window probes ride the
    daemon's chain op over the FOLDED codes (savekmers.c:3941 N fold)
    and feed scan_read_hmm's seed/extend walk at byte parity."""
    prefix, reads = disk_db
    _, sdir = daemon
    cli = REPO / "native" / "kma_cli"
    if not cli.exists():
        pytest.skip("native CLI not built")
    env = dict(os.environ, KMA_DEVSERVE_DIR=sdir)
    out_dev = str(tmp_path / "hdev")
    out_host = str(tmp_path / "hhost")
    r = subprocess.run(
        [str(cli), "-i", reads, "-t_db", prefix, "-o", out_dev, "-hmm",
         "-device", "on"], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "devserve session" in r.stderr
    r = subprocess.run(
        [str(cli), "-i", reads, "-t_db", prefix, "-o", out_host, "-hmm",
         "-device", "off"], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    for ext in (".res", ".fsa", ".aln", ".frag.gz"):
        a = open(out_dev + ext, "rb").read()
        b = open(out_host + ext, "rb").read()
        assert a == b, ext


def test_ck_device_run_via_daemon(daemon, disk_db, tmp_path):
    """-ck -1t1 -device on: counting-scan window probes through the
    daemon's chain op (scan.save_kmers_count lookups) at byte parity."""
    prefix, reads = disk_db
    _, sdir = daemon
    os.environ["KMA_DEVSERVE_DIR"] = sdir
    out_dev = str(tmp_path / "ckdev")
    out_host = str(tmp_path / "ckhost")
    assert main(["-i", reads, "-t_db", prefix, "-o", out_dev, "-1t1",
                 "-ck", "-device", "on"]) in (0, None)
    assert main(["-i", reads, "-t_db", prefix, "-o", out_host, "-1t1",
                 "-ck", "-device", "off"]) in (0, None)
    for ext in (".res", ".fsa", ".aln"):
        a = open(out_dev + ext, "rb").read()
        b = open(out_host + ext, "rb").read()
        assert a == b, ext


def test_dense_assembly_pileup_via_daemon(daemon, disk_db, tmp_path,
                                          monkeypatch):
    """-dense -device on ships the assembly count scatter to the
    daemon's pileup op (ops/pileup.pileup_delta; alnToMatDense
    assembly.c:1446-1497 semantics) at byte parity with the host
    scatter.  Under -device on every template engages, however shallow
    (the depth floor applies only to -device auto)."""
    prefix, reads = disk_db
    _, sdir = daemon
    monkeypatch.setenv("KMA_DEVSERVE_DIR", sdir)
    from kma_tpu.ops.pileup import DELTA_STATS
    calls0 = DELTA_STATS["calls"]
    out_dev = str(tmp_path / "pdev")
    out_host = str(tmp_path / "phost")
    assert main(["-i", reads, "-t_db", prefix, "-o", out_dev, "-1t1",
                 "-dense", "-device", "on"]) in (0, None)
    assert DELTA_STATS["calls"] > calls0, "device pileup never engaged"
    assert main(["-i", reads, "-t_db", prefix, "-o", out_host, "-1t1",
                 "-dense", "-device", "off"]) in (0, None)
    for ext in (".res", ".fsa", ".aln"):
        a = open(out_dev + ext, "rb").read()
        b = open(out_host + ext, "rb").read()
        assert a == b, ext


def test_daemon_survives_dead_client_midframe(daemon, disk_db):
    """A client that dies mid-frame (a SIGPIPE wedge once) must not
    brick the daemon: the very next client gets served promptly."""
    import socket as socketlib
    import struct
    prefix, sdir = daemon
    os.environ["KMA_DEVSERVE_DIR"] = sdir
    # half-sent frame: header promises 1 MB, peer dies after 100 bytes
    s = socketlib.socket(socketlib.AF_UNIX)
    s.connect(socket_path(prefix))
    s.sendall(struct.pack("<Q", 1 << 20))
    s.sendall(b"x" * 100)
    s.close()  # abrupt death, frame incomplete
    # an honest client connected AFTER the dead one is served at once
    t0 = time.time()
    cli = DevClient.connect(prefix)
    assert cli is not None, "daemon wedged by dead client"
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (8, 128), dtype=np.uint8)
    lengths = np.full(8, 100, np.int32)
    from kma_tpu.config import Penalties
    s2, m2, t2, o2 = cli.dense_scan(codes, lengths, Penalties(), False,
                                    None)
    assert len(s2) == 8
    assert time.time() - t0 < 60
    cli.close()


def test_daemon_survives_stalled_client(daemon, disk_db):
    """A connected-but-silent mid-frame peer stalls only its own
    connection thread; concurrent clients keep being served, and the
    stalled peer is dropped at the frame deadline."""
    import socket as socketlib
    import struct
    prefix, sdir = daemon
    os.environ["KMA_DEVSERVE_DIR"] = sdir
    stalled = socketlib.socket(socketlib.AF_UNIX)
    stalled.connect(socket_path(prefix))
    stalled.sendall(struct.pack("<Q", 1 << 16))
    stalled.sendall(b"y" * 10)  # ... and then silence, socket open
    try:
        cli = DevClient.connect(prefix)
        assert cli is not None
        rng = np.random.default_rng(6)
        codes = rng.integers(0, 4, (4, 128), dtype=np.uint8)
        lengths = np.full(4, 100, np.int32)
        from kma_tpu.config import Penalties
        s2, _, _, _ = cli.dense_scan(codes, lengths, Penalties(), False,
                                     None)
        assert len(s2) == 4
        cli.close()
        # the daemon drops the stalled peer at the 5s frame deadline
        stalled.settimeout(30)
        assert stalled.recv(1) == b""  # EOF = dropped, not wedged
    finally:
        stalled.close()


def test_duplicate_daemon_refused_fast(daemon, disk_db):
    """A second devserve for a served DB is refused BEFORE the scanner
    build (not after paying its whole compile)."""
    prefix, sdir = daemon
    env = dict(os.environ, KMA_DEVSERVE_DIR=sdir,
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "kma_tpu", "devserve", "-t_db", prefix],
        env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 1
    assert "already running" in r.stderr
    assert time.time() - t0 < 45


def test_background_daemon_stop_waits_for_exit(disk_db, tmp_path):
    """`devserve -b` daemonizes; `devserve -stop` returns only once the
    daemon process has exited, so nothing is left holding the device."""
    from kma_tpu.devserve import _wait_exit
    prefix, _ = disk_db
    env = dict(os.environ, KMA_DEVSERVE_DIR=str(tmp_path),
               KMA_DEVSERVE_EXIT_WITH=str(os.getpid()),
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "kma_tpu", "devserve", "-t_db", prefix]
    r = subprocess.run(cmd + ["-b", "-batch", "32", "-warm", ""], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    pid = int(r.stderr.rsplit("(pid ", 1)[1].split(")")[0])
    try:
        assert not _wait_exit(pid, 0.5), "daemon is not running"
        r = subprocess.run(cmd + ["-stop"], env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        assert _wait_exit(pid, 0), "daemon still running after -stop"
    finally:
        if not _wait_exit(pid, 0):
            os.kill(pid, 9)


def test_exited_waits_for_all_threads():
    """A process whose main thread is a zombie while another thread still
    runs (as a daemon tearing its device session down) has not exited;
    once every thread is gone it has, reaped or not."""
    from kma_tpu.devserve import _exited
    prog = ("import ctypes, threading, time\n"
            "threading.Thread(target=time.sleep, args=(2,)).start()\n"
            "ctypes.CDLL(None).pthread_exit(None)\n")
    p = subprocess.Popen([sys.executable, "-c", prog])
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            with open("/proc/%d/stat" % p.pid) as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break
            time.sleep(0.05)
        assert not _exited(p.pid)
        deadline = time.time() + 10
        while not _exited(p.pid) and time.time() < deadline:
            time.sleep(0.05)
        assert _exited(p.pid)   # a zombie, not yet reaped
    finally:
        p.wait(timeout=10)
    assert _exited(p.pid)


def test_stale_socket_and_mismatch(disk_db, tmp_path):
    prefix, _ = disk_db
    os.environ["KMA_DEVSERVE_DIR"] = str(tmp_path)
    # no daemon: connect returns None
    assert DevClient.connect(prefix) is None
    # stale socket file: connect returns None (no daemon behind it)
    p = socket_path(prefix)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    open(p, "w").close()
    assert DevClient.connect(prefix) is None
    os.environ.pop("KMA_DEVSERVE_DIR", None)


def _fake_daemon(prefix, sdir):
    """A daemon that completes the hello handshake, then drops the
    connection on the first scan request: a device lost mid-run."""
    import threading

    from kma_tpu.devserve import _recv, _send
    path = os.path.join(sdir, os.path.basename(socket_path(prefix)))
    srv = socketlib.socket(socketlib.AF_UNIX)
    srv.bind(path)
    srv.listen(4)
    idx = load_index(prefix)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                _recv(conn)
                _send(conn, {"ok": 1, "k": int(idx.kmersize),
                             "db_size": int(idx.db_size)},
                      [("voff_map", np.zeros(4, np.int64))])
                _recv(conn)
            except (EOFError, OSError):
                pass
            conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return srv


import socket as socketlib  # noqa: E402


@pytest.mark.parametrize("route", ["native", "python"])
def test_device_on_fails_when_daemon_dies(disk_db, tmp_path, route):
    """-device on with a daemon that dies mid-run exits non-zero with
    the cause; the run never carries on on the host."""
    prefix, reads = disk_db
    sdir = str(tmp_path / "sock")
    os.makedirs(sdir)
    srv = _fake_daemon(prefix, sdir)
    env = dict(os.environ, KMA_DEVSERVE_DIR=sdir,
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    try:
        if route == "native":
            cli = REPO / "native" / "kma_cli"
            if not cli.exists():
                from kma_tpu.run_native import get_lib
                assert get_lib() is not None
            cmd = [str(cli)]
        else:
            cmd = [sys.executable, "-m", "kma_tpu"]
        r = subprocess.run(cmd + ["-i", reads, "-t_db", prefix, "-o",
                                  str(tmp_path / "o"), "-1t1", "-device",
                                  "on"], env=env, capture_output=True,
                           text=True, timeout=120)
    finally:
        srv.close()
    assert r.returncode not in (0, 113), r.stderr[-2000:]
    assert "devserve" in r.stderr


@pytest.mark.parametrize("device", ["auto", "on"])
def test_daemon_for_another_db(disk_db, tmp_path, device):
    """A live daemon that serves another database holds the card: a
    -device on run refuses to start a second backend beside it, while a
    -device auto run says so once and maps on the host, byte-equal to
    -device off."""
    prefix, reads = disk_db
    sdir = str(tmp_path / "sock")
    os.makedirs(sdir)
    os.environ["KMA_DEVSERVE_DIR"] = sdir
    try:
        other = os.path.join(sdir, os.path.basename(
            socket_path(str(tmp_path / "other_db"))))
    finally:
        os.environ.pop("KMA_DEVSERVE_DIR", None)
    srv = socketlib.socket(socketlib.AF_UNIX)
    srv.bind(other)
    srv.listen(4)
    env = dict(os.environ, KMA_DEVSERVE_DIR=sdir, KMA_TPU_DEVICE_AUTO_MB="0",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = {}
    try:
        for dev in (device, "off"):
            outs[dev] = str(tmp_path / dev)
            r = subprocess.run(
                [sys.executable, "-m", "kma_tpu", "-i", reads, "-t_db",
                 prefix, "-o", outs[dev], "-1t1", "-device", dev],
                env=env, capture_output=True, text=True, timeout=120)
            if dev == "on":
                assert r.returncode != 0
                assert "does not serve" in r.stderr
                return
            assert r.returncode == 0, r.stderr[-2000:]
            if dev == "auto":
                assert r.stderr.count("stays on the host") == 1, r.stderr
    finally:
        srv.close()
    for ext in (".res", ".fsa", ".aln"):
        assert open(outs["auto"] + ext, "rb").read() \
            == open(outs["off"] + ext, "rb").read(), ext
    assert gzip.open(outs["auto"] + ".frag.gz").read() \
        == gzip.open(outs["off"] + ".frag.gz").read()

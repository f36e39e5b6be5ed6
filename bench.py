"""Benchmark: the five BASELINE.md configs + the device scan headline.

Measures, on this host:
  1. se_1t1        -- 20k x 100bp SE reads vs ResFinder, -1t1
  2. pe_apm        -- 10k pairs (insert 205), -apm p
  3. ont_bcnano    -- 2k chimeric long reads, -bcNano -bc 0.7
  4. ont_mem       -- same long reads, -mem_mode
  5. ont_hmm       -- same long reads, -hmm (native HMM scan)
  6. full_outputs  -- BASELINE config 5 shape: -1t1 -matrix -vcf -ef
  7. mh_scaling    -- 2-process jax.distributed CPU run, efficiency =
                      reads/s_2proc / (2 * reads/s_1proc)
plus the device step-2 scan throughput (DenseScanner) with a host-parity
assertion (the device result must match the host scanner on the same
reads; a mismatch zeroes the metric).

Every e2e config runs the reference binary and our CLI as subprocesses
(-t 1, byte-compared .res) and reports reads/s for both.  The final line
is ONE JSON object: the headline device-scan metric with a "configs" map
carrying every other row.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
REF_BUILD = REPO / ".ref_build"
TESTDATA = REPO / "testdata"
N_READS = 20000
N_PAIRS = 10000
N_ONT = 2000
READ_LEN = 100
BATCH = 4096

# Global wall budget: the bench must ALWAYS finish and print its JSON
# line inside its time limit (a device section that blows the budget
# would lose the whole record).  Device
# sections run as subprocesses under explicit deadlines and degrade to
# explicit "skipped" rows when the remaining budget is too small.
_T0 = time.monotonic()
BUDGET = float(os.environ.get("KMA_BENCH_BUDGET", 2100))


def _remaining() -> float:
    return BUDGET - (time.monotonic() - _T0)


def _section_subprocess(name: str, cap: float, env=None):
    """Run ``python bench.py --section <name>`` under a deadline; the
    child prints ONE JSON row on stdout.  Never raises."""
    cap = min(cap, max(30.0, _remaining() - 120))
    if cap < 60:
        return {"skipped": "budget exhausted (%ds left)" % _remaining()}
    try:
        r = subprocess.run(
            [sys.executable, str(REPO / "bench.py"), "--section", name],
            capture_output=True, text=True, timeout=cap, env=env)
    except subprocess.TimeoutExpired:
        return {"skipped": "section deadline (%ds)" % cap}
    for line in reversed(r.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                pass
    return {"error": "no row (rc=%s): %s" % (r.returncode,
                                             r.stderr[-300:])}


def _precompile():
    try:
        import compileall
        sys.dont_write_bytecode = False
        compileall.compile_dir(str(REPO / "kma_tpu"), quiet=2)
    except Exception:
        pass


def _gen_se(resf, reads):
    from kma_tpu.io.seq import parse_fasta
    rng = np.random.default_rng(7)
    recs = list(parse_fasta(str(resf)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    with open(reads, "w") as f:
        n = 0
        while n < N_READS:
            _h, codes = recs[rng.integers(len(recs))]
            if len(codes) <= READ_LEN + 1:
                continue
            s = int(rng.integers(0, len(codes) - READ_LEN))
            r = codes[s: s + READ_LEN].copy()
            ne = rng.binomial(READ_LEN, 0.01)
            pos = rng.integers(0, READ_LEN, ne)
            r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write("@r%d\n%s\n+\n%s\n"
                    % (n, "".join("ACGTN"[c] for c in r), "I" * READ_LEN))
            n += 1


def _gen_pe(resf, r1p, r2p):
    from kma_tpu.io.seq import parse_fasta
    rng = np.random.default_rng(11)
    recs = list(parse_fasta(str(resf)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    INS = 205
    with open(r1p, "w") as f1, open(r2p, "w") as f2:
        n = 0
        while n < N_PAIRS:
            _h, codes = recs[rng.integers(len(recs))]
            if len(codes) <= INS + 2:
                continue
            s = int(rng.integers(0, len(codes) - INS))
            frag = codes[s:s + INS]
            r1 = frag[:READ_LEN].copy()
            r2 = comp[frag[-READ_LEN:][::-1]].copy()
            for r in (r1, r2):
                ne = rng.binomial(READ_LEN, 0.01)
                pos = rng.integers(0, READ_LEN, ne)
                r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            f1.write("@p%d/1\n%s\n+\n%s\n"
                     % (n, "".join("ACGTN"[c] for c in r1),
                        "I" * READ_LEN))
            f2.write("@p%d/2\n%s\n+\n%s\n"
                     % (n, "".join("ACGTN"[c] for c in r2),
                        "I" * READ_LEN))
            n += 1


def _gen_ont(resf, reads):
    from kma_tpu.io.seq import parse_fasta
    rng = np.random.default_rng(23)
    recs = [r for r in parse_fasta(str(resf)) if len(r[1]) > 320]
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    with open(reads, "w") as f:
        n = 0
        while n < N_ONT:
            parts = []
            for _ in range(int(rng.integers(1, 4))):
                _h, codes = recs[rng.integers(len(recs))]
                hi = min(1200, len(codes))
                L = int(rng.integers(300, hi)) if hi > 300 else hi
                s = int(rng.integers(0, len(codes) - L + 1))
                frag = codes[s:s + L].copy()
                if rng.random() < 0.5:
                    frag = comp[frag[::-1]]
                parts.append(frag)
            r = np.concatenate(parts)
            out = []
            for c in r:
                x = rng.random()
                if x < 0.02:
                    out.append((c + rng.integers(1, 4)) % 4)
                elif x < 0.035:
                    out.append(c)
                    out.append(rng.integers(0, 4))
                elif x < 0.05:
                    pass
                else:
                    out.append(c)
            r = np.array(out, np.uint8)
            if len(r) < 100:
                continue
            f.write("@n%d\n%s\n+\n%s\n"
                    % (n, "".join("ACGTN"[c] for c in r), "I" * len(r)))
            n += 1


def ensure_assets():
    _precompile()
    sys.path.insert(0, str(REPO))
    from tests.conftest import ensure_reference
    have_ref = ensure_reference()
    TESTDATA.mkdir(exist_ok=True)
    resf = REF_BUILD / "benchmarkCMDs" / "ResFinder.fasta"
    db_prefix = TESTDATA / "bench_resf"
    if not (db_prefix.with_suffix(".comp.b")).exists() and resf.exists():
        from kma_tpu.index.build import build_index
        build_index([str(resf)], str(db_prefix), quiet=True)
    if resf.exists():
        if not (TESTDATA / "bench_reads.fq").exists():
            _gen_se(resf, TESTDATA / "bench_reads.fq")
        if not (TESTDATA / "bench_reads_pe_1.fq").exists():
            _gen_pe(resf, TESTDATA / "bench_reads_pe_1.fq",
                    TESTDATA / "bench_reads_pe_2.fq")
        if not (TESTDATA / "bench_reads_ont.fq").exists():
            _gen_ont(resf, TESTDATA / "bench_reads_ont.fq")
    return have_ref, str(db_prefix)


def _run_wall(cmd, env=None, timeout=600):
    t0 = time.time()
    try:
        r = subprocess.run(cmd, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, env=env,
                           timeout=timeout)
        rc = r.returncode
    except subprocess.TimeoutExpired:
        rc = 124
    return time.time() - t0, rc


def _t4(args):
    out = list(args)
    for i, a in enumerate(out):
        if a == "-t" and i + 1 < len(out):
            out[i + 1] = "4"
    return out


def _gz_eq(a, b):
    import gzip
    with gzip.open(a) as f1, gzip.open(b) as f2:
        return f1.read() == f2.read()


def e2e_config(name, n_frags, ref_args, my_args, out_ref, out_my,
               extra_parity=()):
    """One e2e row: best-of-3 subprocess walls, byte-compared .res (plus
    ``extra_parity`` artifacts: '.x.gz' members are gzip-decompressed,
    '.mapstat' compared modulo the command/date echo)."""
    kma = REF_BUILD / "kma"
    row = {"n": n_frags}
    if kma.exists():
        ref = min(_run_wall([str(kma)] + ref_args)[0] for _ in range(3))
        row["ref_wall_s"] = round(ref, 3)
        row["ref_reads_per_sec"] = round(n_frags / ref, 1)
    my = min(_run_wall([str(REPO / "bin" / "kma")] + my_args)[0]
             for _ in range(3))
    row["wall_s"] = round(my, 3)
    row["reads_per_sec"] = round(n_frags / my, 1)
    # parity is byte-compared NOW, before the -t 4 auxiliary runs below
    # clobber the same output prefixes: the reference is nondeterministic
    # at -t 4 (thread scheduling moves reads), so comparing after those
    # runs would report a false parity failure
    if kma.exists():
        row["vs_ref"] = round(row["reads_per_sec"]
                              / row["ref_reads_per_sec"], 3)
        parity = Path(out_ref + ".res").read_bytes() \
            == Path(out_my + ".res").read_bytes()
        for ext in extra_parity:
            if not parity:
                break
            if ext.endswith(".gz"):
                parity = _gz_eq(out_ref + ext, out_my + ext)
            elif ext == ".mapstat":
                mask = (b"## command", b"## date")
                a = [ln for ln in Path(out_ref + ext).read_bytes()
                     .splitlines() if not ln.startswith(mask)]
                b = [ln for ln in Path(out_my + ext).read_bytes()
                     .splitlines() if not ln.startswith(mask)]
                parity = a == b
            else:
                parity = Path(out_ref + ext).read_bytes() \
                    == Path(out_my + ext).read_bytes()
        row["parity"] = bool(parity)
        if not parity:
            row["reads_per_sec"] = 0.0
            row["vs_ref"] = 0.0
            print(f"# PARITY FAILURE in {name}", file=sys.stderr)
    # auxiliary: the -t 4 walls on both sides (outputs deterministic for
    # ours; the multithreaded reference is the bar a whole chip clears)
    my4 = _run_wall([str(REPO / "bin" / "kma")] + _t4(my_args))[0]
    row["wall_t4_s"] = round(my4, 3)
    if kma.exists():
        ref4 = _run_wall([str(kma)] + _t4(ref_args))[0]
        row["ref_wall_t4_s"] = round(ref4, 3)
    print("# %s: %s" % (name, json.dumps(row)), file=sys.stderr)
    return row


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def mh_scaling(db_prefix):
    """2-process jax.distributed CPU run vs the 1-process run of the SAME
    runtime path (-mh collect/merge) on a compute-dominated workload
    (the 2k-ONT set x8: scan+align dominates), standard
    strong-scaling efficiency = reads/s_2proc / (2 * reads/s_1proc)
    = wall_1proc / (2 * wall_2proc).  BASELINE bar: >= 0.8."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    reps = 8
    reads = ["-i"] + [str(TESTDATA / "bench_reads_ont.fq")] * reps

    def run_n(nproc):
        port = _free_port()
        out = "/tmp/bench_mh%d" % nproc
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "kma_tpu"] + reads + [
             "-t_db", db_prefix, "-o", out, "-bcNano", "-bc", "0.7",
             "-mh", "127.0.0.1:%d,%d,%d" % (port, nproc, pid)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            for pid in range(nproc)]
        errs = [p.communicate(timeout=900)[1] for p in procs]
        dt = time.time() - t0
        ok = all(p.returncode == 0 for p in procs)
        # rank-0 serial share (merge + replicated conclave + stitch)
        serial = [ln for ln in errs[0].decode().splitlines()
                  if "rank-0" in ln]
        return dt, ok, serial[-1] if serial else ""

    # best-of-2 per process count: the box's run-to-run wall noise
    # (~10%) otherwise dominates the efficiency ratio
    t1, ok1, _ = run_n(1)
    t2, ok2, serial = run_n(2)
    t1b, ok1b, _ = run_n(1)
    t2b, ok2b, serial_b = run_n(2)
    if ok1b and t1b < t1:
        t1 = t1b
    if ok2b and t2b < t2:
        t2, serial = t2b, serial_b
    row = {"n": N_ONT * reps, "wall_1proc_s": round(t1, 2),
           "wall_2proc_s": round(t2, 2),
           "rank0_serial": serial.lstrip("# ")}
    if ok1 and ok2:
        row["efficiency"] = round(t1 / (2 * t2), 3)
        parity = Path("/tmp/bench_mh1.res").read_bytes() \
            == Path("/tmp/bench_mh2.res").read_bytes()
        row["parity"] = bool(parity)
        if not parity:
            row["efficiency"] = 0.0
    else:
        row["error"] = "multihost run failed"
    print("# mh_scaling: %s" % json.dumps(row), file=sys.stderr)
    return row


def _device_alive(timeout: int = 180) -> bool:
    try:
        r = subprocess.run(
            [sys.executable, "-c",
             "import jax; print(jax.default_backend())"],
            capture_output=True, timeout=timeout)
        return r.returncode == 0
    except subprocess.TimeoutExpired:
        return False


def device_scan(db_prefix, reads, have_ref):
    """Headline: DenseScanner reads/s on the chip, asserted against the
    host scanner result on the same reads."""
    from kma_tpu.config import Penalties
    from kma_tpu.index.format import load_index
    from kma_tpu.io.pipeline import iter_reads
    from kma_tpu.mapping.scan import SaveKmersScanner
    from kma_tpu.mapping.scan_dense import DenseScanner

    idx = load_index(db_prefix)
    pen = Penalties()
    pen.score_matrix()
    dev = DenseScanner(idx, pen, batch=BATCH)

    rs = list(iter_reads([reads]))
    L = max(len(r.codes) for r in rs)
    N = len(rs)
    codes = np.full((N, L), 4, dtype=np.uint8)
    lengths = np.zeros(N, np.int32)
    for i in range(N):
        codes[i, : len(rs[i].codes)] = rs[i].codes
        lengths[i] = len(rs[i].codes)

    dev.scan_reads(codes[:BATCH], lengths[:BATCH])
    dummy = np.zeros(N, bool)
    dev._rescan_wide(codes, lengths, np.array([0]), np.zeros(N, np.int32),
                     np.zeros(N, np.uint8), [None] * N, dummy)

    best = 0.0
    residual = 0
    scores = modes = tid_lists = None
    for _ in range(3):
        t0 = time.time()
        scores, modes, tid_lists, over = dev.scan_reads(codes, lengths)
        dt = time.time() - t0
        best = max(best, N / dt)
        residual = int(over.sum())

    # on-chip parity assertion vs the host scanner (sampled)
    parity = True
    host = SaveKmersScanner(idx, pen)
    rng = np.random.default_rng(3)
    sample = rng.choice(N, size=min(500, N), replace=False)
    for i in sample.tolist():
        hit = host.scan(rs[i].codes, rs[i].n_positions, rs[i].header)
        if hit is None:
            if int(scores[i]) > 0 and int(modes[i]) >= 0 \
                    and tid_lists[i] is not None and len(tid_lists[i]):
                parity = False
                break
            continue
        dev_t = tid_lists[i]
        if dev_t is None or int(scores[i]) != abs(int(hit.rc_flag)) \
                or list(np.asarray(dev_t).tolist()) \
                != list(np.asarray(hit.templates).tolist()):
            parity = False
            print(f"# device/host scan mismatch at read {i}: "
                  f"dev score={int(scores[i])} tids={dev_t} vs host "
                  f"rc_flag={hit.rc_flag} tids={hit.templates}",
                  file=sys.stderr)
            break

    base = None
    if have_ref:
        kma = REF_BUILD / "kma"
        base = 0.0
        for _ in range(3):
            t0 = time.time()
            subprocess.run([str(kma), "-i", reads, "-o", "/dev/null",
                            "-t_db", db_prefix, "-1t1", "-s2"],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, check=True)
            base = max(base, N_READS / (time.time() - t0))
    return best, base, residual, parity



def nw_kernel_metric():
    """Banded-NW scorer (ops/nw_kernel.nw_band_score): cell updates/s on
    the device (operands device_put once), checked bit-exact against the
    host-oracle nw_band, plus the transfer-inclusive number (numpy
    operands re-shipped every dispatch)."""
    import jax
    from kma_tpu.align.nw import nw_band
    from kma_tpu.config import Penalties
    from kma_tpu.ops.nw_kernel import nw_band_score, stage_code_inputs

    pen = Penalties()
    d = pen.score_matrix()[:5, :5].astype(np.int8)
    DMAT = tuple(tuple(int(x) for x in row) for row in d)
    rng = np.random.default_rng(5)
    B = 2048
    T_LEN, Q_LEN, BAND = 160, 150, 126
    templates, queries, t_lens, q_lens = [], [], [], []
    for _ in range(B):
        t = rng.integers(0, 4, T_LEN).astype(np.uint8)
        q = t[: Q_LEN].copy()
        ne = rng.binomial(Q_LEN, 0.05)
        pos = rng.integers(0, Q_LEN, ne)
        q[pos] = (q[pos] + rng.integers(1, 4, ne)) % 4
        templates.append(t)
        queries.append(q)
        t_lens.append(T_LEN)
        q_lens.append(Q_LEN)
    kflag = np.full(B, -1, np.int32)
    tl, ql, hb, qext, tcol = stage_code_inputs(templates, queries, t_lens,
                                               q_lens, BAND, L=256)

    def fn(*a):
        return nw_band_score(*a, DMAT=DMAT, W1=pen.W1, U=pen.U, MM=pen.MM)

    args_h = (tl, ql, kflag, hb, qext, tcol)
    args_d = tuple(jax.device_put(x) for x in args_h)
    out = np.asarray(jax.block_until_ready(fn(*args_d)))
    # oracle check (host nw_band is oracle-exact vs nw.c)
    ok = True
    for b in range(0, B, 16):
        st = nw_band(templates[b], queries[b], -1, 0, T_LEN, 0, Q_LEN,
                     BAND, d, pen.W1, pen.U, pen.MM, T_LEN)
        if int(st.score) != int(out[b]):
            ok = False
            print(f"# NW kernel mismatch at {b}: {out[b]} vs {st.score}",
                  file=sys.stderr)
            break
    cells1 = B * T_LEN * (BAND + 1)
    best = 0.0
    REP = 16
    for _ in range(3):
        t0 = time.time()
        outs = [fn(*args_d) for _ in range(REP)]
        jax.block_until_ready(outs)
        best = max(best, REP * cells1 / (time.time() - t0))
    # transfer-inclusive: numpy operands re-shipped every dispatch
    t0 = time.time()
    jax.block_until_ready([fn(*args_h) for _ in range(2)])
    with_tx = 2 * cells1 / (time.time() - t0)
    row = {"cell_updates_per_sec": round(best, 0),
           "with_transfers": round(with_tx, 0),
           "exact": bool(ok), "batch": B, "t_len": T_LEN, "band": BAND}
    print("# nw_kernel: %s" % json.dumps(row), file=sys.stderr)
    return row


def device_e2e_metric(db_prefix, reads, daemon_cap=900.0):
    """On-device e2e smoke: a full SE -1t1 run whose step-2 scan runs on
    the device through a devserve session (the persistent device daemon,
    kma_tpu/devserve.py), byte-compared against the reference.

    Reuses a live daemon when one is serving this DB; otherwise starts
    one (cold wall recorded -- dominated by compilation, paid once per
    daemon lifetime) and stops it after.  warm_wall_s is the repeat-run
    wall the daemon buys.  Every client run carries its own deadline: a
    wedged session fails its run instead of hanging, and the bench
    records whatever happened."""
    sys.path.insert(0, str(REPO))
    from kma_tpu.devserve import DevClient

    row = {"n": N_READS}
    started = False
    cli = DevClient.connect(db_prefix)
    if cli is None:
        t0 = time.time()
        try:
            r = subprocess.run(
                [str(REPO / "bin" / "kma"), "devserve", "-t_db",
                 db_prefix, "-warm", "128", "-b"],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=daemon_cap)
            rc = r.returncode
        except subprocess.TimeoutExpired:
            rc = 124
        row["daemon_start_s"] = round(time.time() - t0, 1)
        started = True
        if rc != 0:
            row["skipped"] = ("daemon start timed out (%ds cap)"
                              % daemon_cap if rc == 124
                              else "daemon failed to start")
            print("# device_e2e: %s" % json.dumps(row), file=sys.stderr)
            return row
        cli = DevClient.connect(db_prefix)
        if cli is None:
            row["skipped"] = "daemon started but not connectable"
            print("# device_e2e: %s" % json.dumps(row), file=sys.stderr)
            return row
    cli.close()
    try:
        my_args = ["-i", reads, "-t_db", db_prefix, "-o", "/tmp/bdev",
                   "-1t1", "-t", "1", "-device", "on"]
        walls = [_run_wall([str(REPO / "bin" / "kma")] + my_args,
                           timeout=420)[0] for _ in range(3)]
        row["wall_first_s"] = round(walls[0], 3)
        row["warm_wall_s"] = round(min(walls[1:]), 3)
        row["reads_per_sec_e2e"] = round(N_READS / min(walls[1:]), 1)
        host = min(_run_wall(
            [str(REPO / "bin" / "kma")] + my_args[:-2]
            + ["-device", "off"], timeout=300)[0] for _ in range(3))
        row["host_wall_s"] = round(host, 3)
        row["vs_host"] = round(host / min(walls[1:]), 3)
        kma = REF_BUILD / "kma"
        if kma.exists():
            ref = min(_run_wall(
                [str(kma), "-i", reads, "-t_db", db_prefix, "-o",
                 "/tmp/bdevr", "-1t1", "-t", "1"], timeout=300)[0]
                for _ in range(3))
            row["ref_wall_s"] = round(ref, 3)
            row["vs_ref"] = round(ref / min(walls[1:]), 3)
            parity = all(
                Path("/tmp/bdev" + ext).read_bytes()
                == Path("/tmp/bdevr" + ext).read_bytes()
                for ext in (".res", ".fsa", ".aln"))
            parity = parity and _gz_eq("/tmp/bdev.frag.gz",
                                       "/tmp/bdevr.frag.gz")
            row["parity"] = bool(parity)
            if not parity:
                row["vs_ref"] = 0.0
                row["reads_per_sec_e2e"] = 0.0
                print("# PARITY FAILURE in device_e2e", file=sys.stderr)
        # device NW pre-pass row: the ONT config on the batched pipeline
        # with the step-3 banded-NW window pre-pass on the device (through
        # the live daemon, which holds the device) vs the host run, byte
        # parity enforced
        ont = str(TESTDATA / "bench_reads_ont.fq")
        env = dict(os.environ)
        env["KMA_TPU_NO_FUSED"] = "1"
        nw = {}
        for mode, dev in (("off", "off"), ("auto", "on")):
            args = [sys.executable, "-m", "kma_tpu", "-i", ont,
                    "-t_db", db_prefix, "-o", "/tmp/bnw_" + mode,
                    "-bcNano", "-bc", "0.7", "-t", "1", "-device", dev]
            walls = [_run_wall(args, env=env, timeout=420)[0]
                     for _ in range(3)]
            nw["wall_%s_s" % mode] = round(min(walls[1:]), 3)
        try:
            nw["parity"] = (
                Path("/tmp/bnw_off.res").read_bytes()
                == Path("/tmp/bnw_auto.res").read_bytes()
                and Path("/tmp/bnw_off.fsa").read_bytes()
                == Path("/tmp/bnw_auto.fsa").read_bytes())
        except OSError:
            nw["parity"] = False
        if nw.get("wall_auto_s"):
            nw["vs_host_prepass"] = round(
                nw["wall_off_s"] / nw["wall_auto_s"], 3)
        if not nw["parity"]:
            nw["vs_host_prepass"] = 0.0
        row["nw_prepass"] = nw
    finally:
        if started:
            try:
                subprocess.run(
                    [str(REPO / "bin" / "kma"), "devserve", "-t_db",
                     db_prefix, "-stop"],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                    timeout=120)
            except subprocess.TimeoutExpired:
                pass
    print("# device_e2e: %s" % json.dumps(row), file=sys.stderr)
    return row


def main():
    have_ref, db_prefix = ensure_assets()
    reads = str(TESTDATA / "bench_reads.fq")
    pe1 = str(TESTDATA / "bench_reads_pe_1.fq")
    pe2 = str(TESTDATA / "bench_reads_pe_2.fq")
    ont = str(TESTDATA / "bench_reads_ont.fq")

    configs = {}
    configs["se_1t1"] = e2e_config(
        "se_1t1", N_READS,
        ["-i", reads, "-t_db", db_prefix, "-o", "/tmp/bref1", "-1t1",
         "-t", "1"],
        ["-i", reads, "-t_db", db_prefix, "-o", "/tmp/bmy1", "-1t1",
         "-t", "1", "-device", "off"],
        "/tmp/bref1", "/tmp/bmy1")
    configs["pe_apm"] = e2e_config(
        "pe_apm", N_PAIRS,
        ["-ipe", pe1, pe2, "-t_db", db_prefix, "-o", "/tmp/bref2",
         "-apm", "p", "-t", "1"],
        ["-ipe", pe1, pe2, "-t_db", db_prefix, "-o", "/tmp/bmy2",
         "-apm", "p", "-t", "1", "-device", "off"],
        "/tmp/bref2", "/tmp/bmy2")
    configs["ont_bcnano"] = e2e_config(
        "ont_bcnano", N_ONT,
        ["-i", ont, "-t_db", db_prefix, "-o", "/tmp/bref3", "-bcNano",
         "-bc", "0.7", "-t", "1"],
        ["-i", ont, "-t_db", db_prefix, "-o", "/tmp/bmy3", "-bcNano",
         "-bc", "0.7", "-t", "1", "-device", "off"],
        "/tmp/bref3", "/tmp/bmy3")
    configs["ont_mem"] = e2e_config(
        "ont_mem", N_ONT,
        ["-i", ont, "-t_db", db_prefix, "-o", "/tmp/bref4", "-mem_mode",
         "-t", "1"],
        ["-i", ont, "-t_db", db_prefix, "-o", "/tmp/bmy4", "-mem_mode",
         "-t", "1", "-device", "off"],
        "/tmp/bref4", "/tmp/bmy4")
    configs["ont_hmm"] = e2e_config(
        "ont_hmm", N_ONT,
        ["-i", ont, "-t_db", db_prefix, "-o", "/tmp/bref6", "-hmm",
         "-t", "1"],
        ["-i", ont, "-t_db", db_prefix, "-o", "/tmp/bmy6", "-hmm",
         "-t", "1", "-device", "off"],
        "/tmp/bref6", "/tmp/bmy6", extra_parity=(".fsa", ".aln",
                                                 ".frag.gz"))
    # BASELINE config 5 shape: ConClave + matrix + VCF + mapstat
    configs["full_outputs"] = e2e_config(
        "full_outputs", N_READS,
        ["-i", reads, "-t_db", db_prefix, "-o", "/tmp/bref5", "-1t1",
         "-matrix", "-vcf", "-ef", "-t", "1"],
        ["-i", reads, "-t_db", db_prefix, "-o", "/tmp/bmy5", "-1t1",
         "-matrix", "-vcf", "-ef", "-t", "1", "-device", "off"],
        "/tmp/bref5", "/tmp/bmy5",
        extra_parity=(".mat.gz", ".vcf.gz", ".mapstat", ".fsa", ".aln"))
    try:
        configs["mh_scaling"] = mh_scaling(db_prefix)
    except Exception as e:  # pragma: no cover - never block the headline
        configs["mh_scaling"] = {"error": str(e)[:200]}
        print("# mh_scaling failed: %s" % e, file=sys.stderr)

    if not _device_alive():
        print("# device backend unreachable; scan metric skipped",
              file=sys.stderr)
        ratios = [configs[c].get("vs_ref", 0.0)
                  for c in ("se_1t1", "pe_apm", "ont_bcnano", "ont_mem", "ont_hmm",
                            "full_outputs")]
        geo = float(np.exp(np.mean(np.log(ratios)))) if all(ratios) \
            else 0.0
        print(json.dumps({
            "metric": "e2e_mapping_reads_per_sec",
            "value": configs["se_1t1"].get("reads_per_sec", 0.0),
            "unit": "reads/s e2e (SE -1t1 vs ResFinder, -t 1, byte "
                    "parity; vs_baseline = geomean speedup over the 6 "
                    "configs)",
            "vs_baseline": round(geo, 4),
            "note": "device backend unreachable",
            "configs": configs,
        }))
        return

    # device sections: each is an isolated subprocess under its own
    # deadline, so a stalled section costs its row, never the record
    configs["nw_kernel"] = _section_subprocess("nw_kernel", 420)
    configs["device_scan"] = _section_subprocess("device_scan", 600)
    configs["device_e2e"] = _section_subprocess("device_e2e", 1200)
    for s in ("nw_kernel", "device_scan", "device_e2e"):
        print("# %s: %s" % (s, json.dumps(configs[s])), file=sys.stderr)

    # headline: end-to-end mapping speed vs the reference binary, the
    # geometric mean over the four single-host BASELINE configs (byte
    # parity enforced per config; a parity failure zeroes its row)
    ratios = [configs[c].get("vs_ref", 0.0)
              for c in ("se_1t1", "pe_apm", "ont_bcnano", "ont_mem", "ont_hmm",
                        "full_outputs")]
    geo = float(np.exp(np.mean(np.log(ratios)))) if all(ratios) else 0.0
    se_rps = configs["se_1t1"].get("reads_per_sec", 0.0)
    out = {
        "metric": "e2e_mapping_reads_per_sec",
        "value": se_rps,
        "unit": "reads/s e2e (SE -1t1 vs ResFinder, -t 1, byte parity; "
                "vs_baseline = geomean speedup over the 6 configs)",
        "vs_baseline": round(geo, 4),
        "configs": configs,
    }
    print(json.dumps(out))


def _section_main(name: str) -> None:
    """Child-process entry for one device section: prints ONE JSON row
    on stdout (the parent applies the deadline)."""
    have_ref, db_prefix = ensure_assets()
    reads = str(TESTDATA / "bench_reads.fq")
    if name == "nw_kernel":
        row = nw_kernel_metric()
    elif name == "device_scan":
        best, base, residual, parity = device_scan(db_prefix, reads,
                                                   have_ref)
        vs = best / base if base else 0.0
        row = {
            "reads_per_sec_chip": round(best, 1) if parity else 0.0,
            "vs_ref_s2": round(vs, 4) if parity else 0.0,
            "device_host_parity": parity,
            "residual_host_fallback": residual,
        }
    elif name == "device_e2e":
        row = device_e2e_metric(db_prefix, reads, daemon_cap=700)
    else:
        row = {"error": "unknown section %r" % name}
    print(json.dumps(row))


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--section":
        _section_main(sys.argv[2])
    else:
        main()

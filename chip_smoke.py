"""End-to-end check of the mapping path on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases 0-3
    python chip_smoke.py --four-cards   # four cards: the multi-device paths

Phases (one card):
  0. card and set-up: print the card, refuse anything but a GPU, build
     the native and CUDA libraries from the tracked sources, generate the
     seeded gene panel and read sets (kma_tpu.utils.simdata) and index
     the panel with bin/kma index;
  1. kernels: the run-scoring scan kernel and the banded-NW kernel at
     real widths against their plain jax.numpy versions and the host
     oracles (exact equality), each timed against its plain version;
  2. in-process device runs (no daemon): bin/kma -device on against
     -device off, byte for byte, on the SE reads (-1t1) and on the
     Nanopore reads (-bcNano -bc 0.7, per-component pipeline), with the
     device counters showing the scan and the NW pre-pass ran on the
     card;
  3. a devserve daemon session: SE -1t1, SE chain mode, PE and Nanopore
     jobs through the native CLI, and a Nanopore -dense job through
     python -m kma_tpu, each with -device on against its -device off
     run, and the daemon's per-op request counts (dense, chain, nw,
     pileup).

With --four-cards: the sharded dense scan, chain probes, ConClave, the
NW scorer under shard_map and the pileup psum on a mesh over the four
cards (__graft_entry__.dryrun_multichip on the generated panel and a
4,096-read batch of its SE reads per data shard), and a four-process
-mh run (one card each) against the one-process run.

The parent process never starts JAX: every device step runs in a child,
one at a time, so one process holds a card.  It adopts every orphaned
descendant (the daemon double-forks) and, at the end, stops and reaps
whatever is still running; a leftover process fails the run.  The last
line of stdout is
{"ok": true, "device": {...}}; any failed phase exits non-zero with the
cause on stderr and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KMA = os.path.join(HERE, "bin", "kma")
OUT_EXTS = (".res", ".fsa", ".aln")


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd, env=None, timeout=900, check=True):
    """Run a child; returns (rc, stdout, stderr) text."""
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=HERE)
    if check and p.returncode != 0:
        raise SmokeError("%s exited %d:\n%s" % (" ".join(cmd), p.returncode,
                                               p.stderr[-4000:]))
    return p.returncode, p.stdout, p.stderr


def adopt_orphans() -> None:
    """Become the reaper of every orphaned descendant (the devserve
    daemon double-forks away from its launcher), so that
    stop_descendants finds it.  Linux only; elsewhere a no-op."""
    try:
        import ctypes
        ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER
    except (OSError, AttributeError):
        pass


def _children() -> dict:
    """{pid: state} of this process's children, from /proc."""
    me, out = os.getpid(), {}
    try:
        names = os.listdir("/proc")
    except OSError:
        return out
    for n in names:
        if not n.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % n) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me:
            out[int(n)] = fields[0]
    return out


def _reap() -> None:
    try:
        while os.waitpid(-1, os.WNOHANG)[0]:
            pass
    except ChildProcessError:
        pass


def _wait_children(grace: float, zombies_only: bool = False) -> None:
    """Reap children until none is left (or, with zombies_only, until
    every one left is running), for at most ``grace`` seconds.  A zombie
    cannot be reaped while the device runtime's threads still tear its
    session down."""
    deadline = time.time() + grace
    while time.time() < deadline:
        _reap()
        kids = _children()
        if not kids or (zombies_only and "Z" not in kids.values()):
            return
        time.sleep(0.1)


def stop_descendants(grace: float = 30.0) -> list:
    """Terminate and reap every process still under this one (SIGTERM,
    then SIGKILL); returns the pids that were still running, and any
    child that could not be reaped."""
    _wait_children(grace, zombies_only=True)
    left = set()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        running = [p for p, st in _children().items() if st != "Z"]
        if not running:
            break
        left.update(running)
        for p in running:
            try:
                os.kill(p, sig)
            except ProcessLookupError:
                pass
        _wait_children(grace)
    left.update(_children())
    return sorted(left)


def child(phase: str, work: str, timeout=900) -> dict:
    """Run one device phase of this script in a child process; it prints
    its result as the last stdout line (JSON)."""
    _, out, err = run([sys.executable, os.path.abspath(__file__),
                       "--child", phase, "--work", work], timeout=timeout)
    sys.stderr.write(err[-3000:])
    return json.loads(out.strip().splitlines()[-1])


# -- phase 0 ------------------------------------------------------------------


def card() -> dict:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise SmokeError("nvidia-smi not found: no NVIDIA GPU here")
    _, out, _ = run([smi, "--query-gpu=name,power.limit",
                     "--format=csv,noheader"])
    log("# card: %s" % out.strip())
    _, out, _ = run([sys.executable, "-c",
                     "import jax, json; d = jax.devices(); print(d); "
                     "print(json.dumps({'platform': d[0].platform, "
                     "'kind': d[0].device_kind, 'count': len(d)}))"])
    lines = out.strip().splitlines()
    log("# jax.devices(): %s" % lines[0])
    dev = json.loads(lines[-1])
    if dev["platform"] != "gpu":
        raise SmokeError("JAX platform is %r, not gpu" % dev["platform"])
    return dev


def setup(work: str, sizes, seed: int) -> dict:
    t0 = time.time()
    run([sys.executable, "-c",
         "from kma_tpu.run_native import get_lib; "
         "from kma_tpu.align.native_aln import get_lib as a; "
         "from kma_tpu.io.native_io import get_lib as i; "
         "from kma_tpu.mapping.native_chain import get_lib as c; "
         "from kma_tpu.assemble.native_assem import get_lib as s; "
         "import sys; sys.exit(0 if all(f() is not None for f in "
         "(get_lib, a, i, c, s)) else 1)"])
    if not os.access(os.path.join(HERE, "native", "kma_cli"), os.X_OK):
        raise SmokeError("native CLI was not built")
    run([sys.executable, "-c",
         "from kma_tpu.ops.nw_kernel import build_cuda_lib; "
         "print(build_cuda_lib())"])
    t_build = time.time() - t0
    from kma_tpu.utils import simdata
    paths = simdata.generate(os.path.join(work, "data"), seed, sizes,
                             index=True)
    log("# set-up: native + CUDA build %.1f s, data + index %.1f s "
        "(%d SE, %d PE pairs, %d ONT reads; %d templates)"
        % (t_build, time.time() - t0 - t_build, sizes.se, sizes.pe,
           sizes.ont, sizes.templates))
    return paths


# -- phase 1 (child) ------------------------------------------------------------


def _median_ms(fn, reps=7):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(1e3 * (time.perf_counter() - t0))
    ts.sort()
    return ts[len(ts) // 2]


def child_kernels(work: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from kma_tpu.align.nw import nw_band
    from kma_tpu.config import Penalties
    from kma_tpu.index.format import load_index
    from kma_tpu.io.pipeline import iter_reads
    from kma_tpu.mapping.scan import SaveKmersScanner
    from kma_tpu.mapping.scan_dense import (DenseScanner,
                                            dense_scan_device)
    from kma_tpu.ops import nw_kernel
    from kma_tpu.utils.simdata import make_nw_windows

    assert jax.default_backend() == "gpu", jax.default_backend()
    data = os.path.join(work, "data")
    idx = load_index(os.path.join(data, "panel"))
    pen = Penalties()
    pen.score_matrix()
    res = {}

    # scan: batch 4096 (half SE reads, half PE mates) at the panel's t_pad
    B, L = 4096, 128
    reads = []
    for path, n in (("se.fq", B // 2), ("pe_1.fq", B // 2)):
        for i, r in enumerate(iter_reads([os.path.join(data, path)])):
            if i >= n:
                break
            reads.append(r.codes)
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, c in enumerate(reads):
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    kern = DenseScanner(idx, pen, batch=B)
    plain = DenseScanner(idx, pen, batch=B, didx=kern.didx)
    plain.kernel_mode = None
    assert kern.kernel_mode == "compiled"
    got_k = kern.scan_reads(codes, lengths)
    got_p = plain.scan_reads(codes, lengths)
    for a, b in zip(got_k[:2] + got_k[3:], got_p[:2] + got_p[3:]):
        assert np.array_equal(a, b), "scan kernel != plain loop"
    for a, b in zip(got_k[2], got_p[2]):
        assert (a is None) == (b is None)
        assert a is None or np.array_equal(a, b), "tie list differs"
    host = SaveKmersScanner(idx, pen)
    n_or = 0
    for i in range(0, B, 8):
        if got_k[3][i]:
            continue
        r = codes[i, : lengths[i]]
        hit = host.scan(r, np.flatnonzero(r == 4).astype(np.int32), b"r")
        if hit is None:
            assert got_k[1][i] == 0, "read %d: host unmapped" % i
        else:
            assert got_k[0][i] == hit.rc_flag, "read %d score" % i
            assert got_k[2][i].tolist() == hit.templates.tolist()
        n_or += 1
    d = kern.didx
    cj, lj = jnp.asarray(codes), jnp.asarray(lengths)

    def scan_step(mode):
        return lambda: dense_scan_device(
            cj, lj, d.exist, d.kv, d.bits, sparams=kern._sparams(L, 0),
            B=B, flat_cap=kern.flat_headroom * B,
            small_ids=kern.small_ids, mega=d.mega, size=d.size,
            max_probe=d.max_probe, t_pad=d.t_pad, n_lists=d.n_lists,
            kernel_mode=mode, merged=True)
    res["scan"] = {"batch": B, "t_pad": int(d.t_pad),
                   "mapped": int((got_k[1] != 0).sum()),
                   "host_oracle_reads": n_or,
                   "kernel_ms": _median_ms(scan_step("compiled")),
                   "plain_ms": _median_ms(scan_step(None))}

    # NW: 1024 windows, bands 64-128, rows up to the longest window
    NB = 1024
    w = make_nw_windows(np.random.default_rng(11), NB)
    ts, qs, tl, ql, ks, bands = (w[k] for k in ("t", "q", "tl", "ql", "kf",
                                                "band"))
    d5 = pen.score_matrix()[:5, :5].astype(np.int64)
    DMAT = tuple(tuple(int(x) for x in row) for row in d5)
    tlv, qlv, hbv, qext, tcol = nw_kernel.stage_code_inputs(
        ts, qs, tl, ql, np.asarray(bands), L=256)
    kfv = np.asarray(ks, np.int32)
    args = [jnp.asarray(a) for a in (tlv, qlv, kfv, hbv, qext, tcol)]
    kw = dict(DMAT=DMAT, W1=pen.W1, U=pen.U, MM=pen.MM)
    got = np.asarray(nw_kernel.nw_band_score(*args, **kw))
    ref = np.asarray(nw_kernel.nw_band_score_plain(*args, **kw))
    assert np.array_equal(got, ref), \
        "NW kernel != plain at %s" % np.flatnonzero(got != ref)[:8]
    for b in range(0, NB, 16):
        band = bands[b] + (bands[b] & 1)
        exp = nw_band(ts[b], qs[b], ks[b], 0, tl[b], 0, ql[b], band, d5,
                      pen.W1, pen.U, pen.MM, tl[b]).score
        assert got[b] == exp, "NW window %d: %d != host %d" % (b, got[b],
                                                              exp)
    res["nw"] = {"windows": NB, "rows": int(tcol.shape[0]),
                 "host_oracle_windows": NB // 16,
                 "kernel_ms": _median_ms(
                     lambda: nw_kernel.nw_band_score(*args, **kw)),
                 "plain_ms": _median_ms(
                     lambda: nw_kernel.nw_band_score_plain(*args, **kw))}
    return res


def child_dryrun(work: str) -> dict:
    import jax
    sys.path.insert(0, HERE)
    import __graft_entry__
    assert jax.default_backend() == "gpu" and len(jax.devices()) >= 4
    data = os.path.join(work, "data")
    return __graft_entry__.dryrun_multichip(
        4, db_prefix=os.path.join(data, "panel"),
        reads=os.path.join(data, "se.fq"), batch_per_shard=4096)


# -- phases 2 and 3 -------------------------------------------------------------


def same_outputs(a: str, b: str) -> None:
    for ext in OUT_EXTS:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            if fa.read() != fb.read():
                raise SmokeError("%s%s differs from %s%s" % (a, ext, b, ext))
    with gzip.open(a + ".frag.gz") as fa, gzip.open(b + ".frag.gz") as fb:
        if fa.read() != fb.read():
            raise SmokeError("%s.frag.gz content differs" % a)


def counters(err: str) -> dict:
    m = re.search(r"# device counters: scan_batches=(\d+) nw_windows=(\d+)"
                  r" nw_dispatches=(\d+)", err)
    out = {"scan_batches": 0, "nw_windows": 0, "nw_dispatches": 0}
    if m:
        out = dict(zip(out, map(int, m.groups())))
    m = re.search(r"predev (\d+)", err)
    out["predev"] = int(m.group(1)) if m else 0
    return out


def pair(work: str, name: str, args, env, cmd=(KMA,)) -> tuple:
    """-device on and -device off runs of one job; returns (on stderr,
    on wall s, off wall s)."""
    on = os.path.join(work, name + "_on")
    off = os.path.join(work, name + "_off")
    t0 = time.time()
    _, _, err = run([*cmd, *args, "-o", on, "-device", "on"], env=env)
    t1 = time.time()
    run([*cmd, *args, "-o", off, "-device", "off"], env=env)
    t2 = time.time()
    same_outputs(on, off)
    return err, t1 - t0, t2 - t1


def phase2(work: str, paths: dict) -> dict:
    env = dict(os.environ, KMA_ALN_PROF="1")
    env["KMA_DEVSERVE_DIR"] = os.path.join(work, "no_daemon")
    res = {}
    # the Nanopore job runs the per-component pipeline, whose step 3
    # exports heavy lead/trail windows to the device NW pre-pass
    jobs = (("se_1t1", ["-i", paths["se"], "-1t1"], env,
             ("scan_batches",)),
            ("ont", ["-i", paths["ont"], "-bcNano", "-bc", "0.7"],
             dict(env, KMA_TPU_NO_FUSED="1"), ("nw_windows", "predev")))
    for name, args, job_env, need in jobs:
        err, t_on, t_off = pair(work, name, args + ["-t_db", paths["db"]],
                                job_env)
        c = counters(err)
        if any(c[k] <= 0 for k in need):
            raise SmokeError("%s: device counters show no device work: %s"
                             % (name, c))
        c.update(wall_on_s=round(t_on, 3), wall_off_s=round(t_off, 3))
        res[name] = c
        log("# phase 2 %s: outputs byte-equal; %s" % (name, c))
    return res


def phase3(work: str, paths: dict) -> dict:
    from kma_tpu.devserve import DevClient
    sock = os.path.join(work, "sock")
    os.makedirs(sock, exist_ok=True)
    env = dict(os.environ, KMA_DEVSERVE_DIR=sock,
               KMA_DEVSERVE_LOG=os.path.join(work, "devserve.log"),
               KMA_DEVSERVE_EXIT_WITH=str(os.getpid()))
    os.environ["KMA_DEVSERVE_DIR"] = sock
    db = paths["db"]
    t0 = time.time()
    _, _, err = run([KMA, "devserve", "-t_db", db, "-b"], env=env)
    m = re.search(r"pid (\d+)", err)
    pid = int(m.group(1)) if m else None
    log("# phase 3: daemon up in %.1f s (pid %s)" % (time.time() - t0, pid))
    res = {}
    try:
        ont = ["-i", paths["ont"], "-bcNano", "-bc", "0.7"]
        # the native CLI scans through the daemon and keeps step 3 and
        # assembly on the host; the Python pipeline also sends the NW
        # pre-pass and the -dense pileup to the daemon
        py = (sys.executable, "-m", "kma_tpu")
        jobs = (("d_se_1t1", ["-i", paths["se"], "-1t1"], env, (KMA,),
                 ("dense",)),
                ("d_se_chain", ["-i", paths["se"]], env, (KMA,),
                 ("chain",)),
                ("d_pe", ["-ipe", paths["pe1"], paths["pe2"]], env, (KMA,),
                 ("chain",)),
                ("d_ont", ont, env, (KMA,), ("chain",)),
                ("d_py_ont_dense", ont + ["-dense"],
                 dict(env, KMA_TPU_NO_FUSED="1", PYTHONPATH=HERE), py,
                 ("chain", "nw", "pileup")))
        for name, args, job_env, cmd, ops in jobs:
            cli = DevClient.connect(db)
            before = cli.stats()
            err, t_on, t_off = pair(work, name, args + ["-t_db", db],
                                    job_env, cmd)
            after = cli.stats()
            cli.close()
            if "# device: using devserve session" not in err:
                raise SmokeError("%s did not attach to the daemon" % name)
            served = {k: after.get(k, 0) - before.get(k, 0) for k in after}
            if any(served.get(op, 0) <= 0 for op in ops):
                raise SmokeError("%s: daemon served none of some op in %s "
                                 "(%s)" % (name, ops, served))
            res[name] = {"served": served, "wall_on_s": round(t_on, 3),
                         "wall_off_s": round(t_off, 3)}
            log("# phase 3 %s: outputs byte-equal; daemon served %s"
                % (name, served))
    finally:
        # -stop returns once the daemon process has exited
        rc, _, err = run([KMA, "devserve", "-t_db", db, "-stop"], env=env,
                         check=False)
        left = stop_descendants()
    if rc != 0 or left:
        raise SmokeError("daemon (pid %s) did not stop: -stop exited %d, "
                         "still running %s\n%s" % (pid, rc, left, err))
    log("# phase 3: daemon stopped")
    return res


# -- four cards ---------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def four_cards(work: str, paths: dict, templates: int) -> dict:
    dry = child("dryrun", work, timeout=900)
    if dry.get("templates") != templates or dry.get("pileup_frags", 0) <= 0 \
            or dry.get("mesh") != [2, 2]:
        raise SmokeError("dry run did not check the panel's sharded "
                         "path: %s" % dry)
    res = {"dryrun": dry}
    log("# four cards: sharded dense scan (vs one card: %s), chain probes, "
        "ConClave, NW (%d windows) under shard_map, pileup psum (%d "
        "frags on template %d) bit-equal on a %s mesh, %d templates, "
        "batch %d" % (dry["single_device_scan"], dry["nw_windows"],
                      dry["pileup_frags"], dry["pileup_template"],
                      dry["mesh"], dry["templates"], dry["batch"]))
    args = ["-i", paths["se"], "-t_db", paths["db"], "-1t1", "-device",
            "on"]
    env = dict(os.environ, KMA_DEVSERVE_DIR=os.path.join(work, "nd"),
               CUDA_VISIBLE_DEVICES="0")
    one = os.path.join(work, "mh1")
    t0 = time.time()
    run([KMA, *args, "-o", one], env=env)
    t1 = time.time() - t0
    env.pop("CUDA_VISIBLE_DEVICES")
    four = os.path.join(work, "mh4")
    port = _free_port()
    t0 = time.time()
    procs = [subprocess.Popen(
        [KMA, *args, "-o", four, "-mh", "127.0.0.1:%d,4,%d" % (port, pid)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, cwd=HERE) for pid in range(4)]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=900)[1])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SmokeError("-mh run timed out")
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise SmokeError("-mh process exited %d:\n%s"
                             % (p.returncode, err[-3000:]))
    same_outputs(four, one)
    res["mh"] = {"procs": 4, "wall_1proc_s": round(t1, 3),
                 "wall_4proc_s": round(time.time() - t0, 3)}
    log("# four cards: -mh 4-process outputs byte-equal to 1 process; %s"
        % res["mh"])
    return res


# -- main -------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--work", default=os.path.join(HERE, ".cache",
                                                   "smoke"))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--se", type=int, default=None)
    ap.add_argument("--pe", type=int, default=None)
    ap.add_argument("--ont", type=int, default=None)
    ap.add_argument("--small", action="store_true",
                    help="test-sized data (simdata.SMALL)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        sys.path.insert(0, HERE)
        fn = {"kernels": child_kernels, "dryrun": child_dryrun}[a.child]
        print(json.dumps(fn(a.work)))
        return 0

    sys.path.insert(0, HERE)
    try:
        import kma_tpu  # noqa: F401  (the program must be beside us)
        from kma_tpu.utils import simdata
    except ImportError as err:
        print("chip_smoke: kma_tpu not found beside %s (%s)" % (HERE, err),
              file=sys.stderr)
        return 2
    t_start = time.time()
    adopt_orphans()
    try:
        dev = card()
        if a.four_cards and dev["count"] < 4:
            raise SmokeError("--four-cards needs 4 GPUs, found %d"
                             % dev["count"])
        if os.path.exists(a.work):
            shutil.rmtree(a.work)
        os.makedirs(a.work)
        over = {k: v for k, v in (("se", a.se), ("pe", a.pe),
                                  ("ont", a.ont)) if v is not None}
        if a.four_cards:
            # the multi-device paths map SE reads only
            over.update(pe=0, ont=0)
        sizes = dataclasses.replace(
            simdata.SMALL if a.small else simdata.Sizes(), **over)
        paths = setup(a.work, sizes, a.seed)
        report = {"sizes": dataclasses.asdict(sizes)}
        if a.four_cards:
            report["four_cards"] = four_cards(a.work, paths,
                                              sizes.templates)
        else:
            k = child("kernels", a.work)
            log("# phase 1 kernels on %s (median of 7 warm runs): scan "
                "batch %d t_pad %d: kernel %.3f ms, plain %.3f ms; NW %d "
                "windows x %d rows: kernel %.3f ms, plain %.3f ms"
                % (_smi_line(), k["scan"]["batch"], k["scan"]["t_pad"],
                   k["scan"]["kernel_ms"], k["scan"]["plain_ms"],
                   k["nw"]["windows"], k["nw"]["rows"],
                   k["nw"]["kernel_ms"], k["nw"]["plain_ms"]))
            report["kernels"] = k
            report["phase2"] = phase2(a.work, paths)
            report["phase3"] = phase3(a.work, paths)
        report["wall_s"] = round(time.time() - t_start, 1)
        with open(os.path.join(a.work, "report.json"), "w") as f:
            json.dump(report, f, indent=1)
    except (SmokeError, subprocess.TimeoutExpired, AssertionError,
            OSError) as err:
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    finally:
        left = stop_descendants()
    if left:
        print("chip_smoke: FAILED: processes still running at the end "
              "(now stopped): %s" % left, file=sys.stderr)
        return 1
    log("# card: %s" % _smi_line())
    print(json.dumps({"ok": True, "device": dev}))
    return 0


def _smi_line() -> str:
    _, out, _ = run(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"])
    return " | ".join(out.strip().splitlines())


if __name__ == "__main__":
    sys.exit(main())

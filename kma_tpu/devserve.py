"""Persistent device session: the ``kma shm`` analog for the device.

The reference amortizes DB load across runs by parking the index in
SysV shared memory (shm.c:51-153; runs attach with ``-shm``).  The
device equivalent must park MORE than host memory: the device-resident
index image, the compiled executables, and the live backend session
itself (a JAX process reserves most of the card's memory, so one
process per card serves every run).  None of those survive a process,
so the analog is a small daemon: ``kma devserve -t_db DB`` loads the DB
once, builds the dense device scanner, pre-warms the hot compile shapes,
and serves scan batches over a unix socket.  Mapping runs with
``-device on`` detect the socket and ship batches instead of starting a
backend of their own -- the client side needs numpy and a socket, not
jax.

Protocol: one request/response frame per call.
``u64 header_len | header JSON | concat(raw array bytes)``;
header = {"meta": {...}, "arrays": [[name, dtype, shape], ...]}.
Arrays are C-contiguous little-endian numpy buffers.

Ops:
- hello:  client identity check {db, sig}; reply carries k and the
  list-id -> values-offset map the chain/PE clients need.
- dense:  step-2 -1t1 scan (scan_dense.DenseScanner.scan_reads).
- chain:  per-window hash probes for both strands (chain_device
  _chain_lookup); feeds the native chain splicer / PE combiners.
- nw:     batched banded-NW candidate scores (ops/nw_kernel.py).
- pileup: dense assembly count scatter (ops/pileup.py).
- stats:  how many requests of each op the daemon has served.
- stop:   shut the daemon down.

Reference roles: shm.c:51 (persistent DB residency), kmers.c:51-290
(the step-2 batch driver the dense op serves).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_HDR = struct.Struct("<Q")

# Robustness deadlines (seconds).  A wedged peer must never brick the
# daemon (one client dying mid-frame once left the old
# single-threaded accept loop blocked in kernel recv forever):
#  - FRAME: once the first byte of a frame arrives, the rest must
#    follow promptly; a half-sent frame drops the CONNECTION only.
#  - IDLE: a connected-but-silent client is allowed (the native CLI
#    holds its connection across its own step-3 work between batches),
#    but not forever.
_FRAME_TIMEOUT = float(os.environ.get("KMA_DEVSERVE_FRAME_TIMEOUT", 60))
_IDLE_TIMEOUT = float(os.environ.get("KMA_DEVSERVE_IDLE_TIMEOUT", 3600))
_PROF = bool(os.environ.get("KMA_DEVSERVE_PROF"))


def _fnv1a64(s: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in s:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def socket_path(db_prefix: str) -> str:
    """Per-DB socket path, keyed by FNV-1a of the resolved prefix (the
    same trivially-portable hash the native CLI client computes)."""
    real = os.path.realpath(db_prefix)
    h = "%016x" % _fnv1a64(real.encode())
    return os.path.join(_sock_dir(), h + ".sock")


def probe_live(db_prefix: str, timeout: float = 3.0) -> bool:
    """True when a daemon is accepting connections for this DB's socket.
    Cheap (no jax import, no handshake) -- used to refuse a duplicate
    daemon BEFORE paying the scanner build."""
    path = os.environ.get("KMA_DEVSERVE_SOCKET") or socket_path(db_prefix)
    if not os.path.exists(path):
        return False
    s = socket.socket(socket.AF_UNIX)
    s.settimeout(timeout)
    try:
        s.connect(path)
        return True
    except OSError:
        return False
    finally:
        s.close()


def _sock_dir() -> str:
    return os.environ.get("KMA_DEVSERVE_DIR") or os.path.join(
        tempfile.gettempdir(), "kma_devserve_%d" % os.getuid())


def live_daemons() -> List[str]:
    """Sockets of every daemon (any DB) accepting connections: a live
    daemon holds the device, so a run must not start a backend beside
    it."""
    if os.environ.get("KMA_DEVSERVE_SOCKET"):
        paths = [os.environ["KMA_DEVSERVE_SOCKET"]]
    else:
        try:
            paths = [os.path.join(_sock_dir(), n)
                     for n in sorted(os.listdir(_sock_dir()))
                     if n.endswith(".sock")]
        except OSError:
            return []
    live = []
    for p in paths:
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(1.0)
        try:
            s.connect(p)
            live.append(p)
        except OSError:
            pass
        finally:
            s.close()
    return live


def reap_stale_sockets() -> None:
    """Unlink sockets in the devserve dir whose daemon is gone."""
    d = _sock_dir()
    try:
        names = os.listdir(d)
    except OSError:
        return
    for n in names:
        if not n.endswith(".sock"):
            continue
        p = os.path.join(d, n)
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(1.0)
        try:
            s.connect(p)
        except (ConnectionRefusedError, FileNotFoundError):
            try:
                os.unlink(p)
            except OSError:
                pass
        except OSError:
            pass
        finally:
            s.close()


def db_signature(db_prefix: str) -> List:
    """Cheap DB identity: size+mtime of the frozen hashmap file."""
    for ext in (".comp.b", ".b"):
        p = db_prefix + ext
        if os.path.exists(p):
            st = os.stat(p)
            return [ext, st.st_size, int(st.st_mtime)]
    return ["?", 0, 0]


def _send(sock: socket.socket, meta: dict,
          arrays: Optional[List[Tuple[str, np.ndarray]]] = None) -> None:
    arrays = arrays or []
    desc = []
    bufs = []
    for name, a in arrays:
        a = np.ascontiguousarray(a)
        desc.append([name, a.dtype.str, list(a.shape)])
        bufs.append(a)
    hdr = json.dumps({"meta": meta, "arrays": desc}).encode()
    sock.sendall(_HDR.pack(len(hdr)))
    sock.sendall(hdr)
    for a in bufs:
        sock.sendall(memoryview(a).cast("B"))


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise EOFError("peer closed")
        got += r
    return buf


def _recv(sock: socket.socket, idle_timeout: Optional[float] = None,
          frame_timeout: Optional[float] = None
          ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Receive one frame.  With timeouts set: wait up to idle_timeout
    for the frame to start, then up to frame_timeout for the rest --
    socket.timeout propagates to the caller, who drops the peer."""
    if idle_timeout is not None:
        sock.settimeout(idle_timeout)
    head = _recv_exact(sock, _HDR.size)
    if frame_timeout is not None:
        sock.settimeout(frame_timeout)
    (hlen,) = _HDR.unpack(bytes(head))
    if hlen > (64 << 20):
        raise EOFError("oversized frame header")
    hdr = json.loads(bytes(_recv_exact(sock, hlen)))
    arrays = {}
    for name, dt, shape in hdr["arrays"]:
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        raw = _recv_exact(sock, n)
        arrays[name] = np.frombuffer(raw, dtype=dt).reshape(shape)
    return hdr["meta"], arrays


def _pack_tid_lists(tid_lists) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged list-of-arrays -> (has u8, counts i32, flat i32)."""
    has = np.fromiter((t is not None for t in tid_lists), np.uint8,
                      len(tid_lists))
    counts = np.fromiter((0 if t is None else len(t) for t in tid_lists),
                         np.int32, len(tid_lists))
    total = int(counts.sum())
    flat = np.empty(total, np.int32)
    off = 0
    for t in tid_lists:
        if t is not None and len(t):
            flat[off: off + len(t)] = t
            off += len(t)
    return has, counts, flat


def _unpack_tid_lists(has, counts, flat) -> list:
    offs = np.cumsum(counts) - counts
    out: list = [None] * len(has)
    for i in range(len(has)):
        if has[i]:
            out[i] = flat[offs[i]: offs[i] + counts[i]]
    return out


# ---------------------------------------------------------------------------
# server


class DevServer:
    """Holds the device-resident index + compiled scan entry points."""

    def __init__(self, db_prefix: str, batch: int = 2048):
        import jax  # noqa: F401  (backend init up front)
        from .config import Penalties
        from .index.format import load_index
        from .mapping.scan_dense import DenseIndex, DenseScanner

        self.db = os.path.realpath(db_prefix)
        self.sig = db_signature(db_prefix)
        self.idx = load_index(db_prefix)
        self.batch = batch
        self.didx = DenseIndex.from_host(self.idx)
        self._scanner_cls = DenseScanner
        self._default_pen = Penalties()
        self.scanners: Dict[tuple, object] = {}
        self.voff_map = np.asarray(self.didx.list_voff, np.int64)
        self.served: Dict[str, int] = {}

    # -- op implementations -------------------------------------------------

    def _scanner(self, meta: dict):
        key = (int(meta["M"]), int(meta["MM"]), int(meta["U"]),
               int(meta["W1"]), bool(meta.get("exhaustive")),
               meta.get("proxi_frac"))
        sc = self.scanners.get(key)
        if sc is None:
            import dataclasses
            pen = dataclasses.replace(self._default_pen, M=key[0],
                                      MM=key[1], U=key[2], W1=key[3])
            sc = self._scanner_cls(self.idx, pen, exhaustive=key[4],
                                   proxi_frac=key[5], batch=self.batch,
                                   didx=self.didx)
            self.scanners[key] = sc
        return sc

    def _dense_dispatch(self, meta, arrays):
        """Dispatch-only half of the dense op (pipelined clients)."""
        sc = self._scanner(meta)
        h = sc.scan_dispatch(np.asarray(arrays["codes"]),
                             np.asarray(arrays["lengths"]))
        return sc, h

    @staticmethod
    def _dense_pack(sc, h):
        scores, modes, tid_lists, over = sc.scan_resolve(h)
        has, counts, flat = _pack_tid_lists(tid_lists)
        return {"ok": 1}, [("scores", scores.astype(np.int32)),
                           ("modes", modes.astype(np.uint8)),
                           ("over", over.astype(np.uint8)),
                           ("has", has), ("counts", counts),
                           ("flat", flat)]

    def _op_dense(self, meta, arrays):
        sc, h = self._dense_dispatch(meta, arrays)
        return self._dense_pack(sc, h)

    def _op_chain(self, meta, arrays):
        # wide windows ride the RLE-compacted device->host transfer
        # (chain_device.chain_lookup_dense); the daemon expands to the
        # dense rows locally, so the wire protocol stays unchanged
        from .mapping.chain_device import chain_lookup_dense
        rows_f, rows_rc = chain_lookup_dense(
            self.didx, self.idx, np.asarray(arrays["codes"]),
            np.asarray(arrays["lengths"]))
        return {"ok": 1}, [("rows_f", np.asarray(rows_f, np.int32)),
                           ("rows_rc", np.asarray(rows_rc, np.int32))]

    def _op_nw(self, meta, arrays):
        from .ops.nw_kernel import nw_band_score
        DMAT = tuple(tuple(int(x) for x in row) for row in meta["dmat"])
        sc = nw_band_score(
            np.asarray(arrays["t_len"], np.int32),
            np.asarray(arrays["q_len"], np.int32),
            np.asarray(arrays["kflag"], np.int32),
            np.asarray(arrays["hband"], np.int32),
            np.asarray(arrays["qext"], np.uint8),
            np.asarray(arrays["tcol"], np.uint8),
            DMAT=DMAT, W1=int(meta["W1"]), U=int(meta["U"]),
            MM=int(meta["MM"]))
        return {"ok": 1}, [("scores", np.asarray(sc, np.int32))]

    def _op_pileup(self, meta, arrays):
        from .ops.pileup import pileup_delta
        delta = pileup_delta(
            np.asarray(arrays["t_flat"], np.uint8),
            np.asarray(arrays["q_flat"], np.uint8),
            np.asarray(arrays["offs"], np.int64),
            np.asarray(arrays["starts"], np.int32),
            int(meta["t_len"]))
        return {"ok": 1}, [("delta", np.asarray(delta, np.int64))]

    def _op_stats(self, meta, arrays):
        return {"ok": 1, "served": dict(self.served)}, []

    def _op_hello(self, meta, arrays):
        if meta.get("db") != self.db or meta.get("sig") != self.sig:
            return {"ok": 0, "err": "db mismatch: serving %s" % self.db}, []
        return {"ok": 1, "k": int(self.idx.kmersize),
                "db_size": int(self.idx.db_size)}, \
            [("voff_map", self.voff_map)]

    # -- warm-up ------------------------------------------------------------

    def warm(self, lengths=(128,), verbose=True):
        """Compile + execute the hot shapes once so client runs never
        pay the compile / first-dispatch latency."""
        rng = np.random.default_rng(0)
        sc = self._scanner({"M": self._default_pen.M,
                            "MM": self._default_pen.MM,
                            "U": self._default_pen.U,
                            "W1": self._default_pen.W1,
                            "exhaustive": False, "proxi_frac": None})
        for L in lengths:
            t0 = time.time()
            codes = rng.integers(0, 4, (self.batch, L), dtype=np.uint8)
            lens = np.full(self.batch, min(100, L), np.int32)
            sc.scan_reads(codes, lens)
            # tier-1 rescan shape (fires on overflow ties)
            sel = np.arange(min(8, self.batch), dtype=np.int64)
            scores = np.zeros(self.batch, np.int32)
            modes = np.zeros(self.batch, np.uint8)
            over = np.zeros(self.batch, bool)
            tid_lists: list = [None] * self.batch
            sc._rescan_wide(codes, lens, sel, scores, modes, tid_lists,
                            over)
            if verbose:
                print("# devserve: warmed dense L=%d in %.1fs"
                      % (L, time.time() - t0), file=sys.stderr)
        # chain lookup shape (default-mode / ONT runs)
        if int(self.idx.kmersize) <= 16:
            from .mapping.chain_device import _chain_lookup
            d = self.didx
            for L in lengths:
                t0 = time.time()
                codes = rng.integers(0, 4, (self.batch, L), dtype=np.uint8)
                lens = np.full(self.batch, min(100, L), np.int32)
                import jax
                jax.block_until_ready(_chain_lookup(
                    d.exist, d.kv, codes, lens, k=int(self.idx.kmersize),
                    mega=d.mega, size=d.size, max_probe=d.max_probe))
                if verbose:
                    print("# devserve: warmed chain L=%d in %.1fs"
                          % (L, time.time() - t0), file=sys.stderr)

    # -- serve loop ----------------------------------------------------------

    def serve(self, sock_path: Optional[str] = None,
              ready_cb=None) -> None:
        sock_path = sock_path or socket_path(self.db)
        d = os.path.dirname(sock_path)
        os.makedirs(d, exist_ok=True)
        try:
            os.chmod(d, 0o700)
        except OSError:
            pass
        if os.path.exists(sock_path):
            # stale socket from a dead daemon: connectable means live
            probe = socket.socket(socket.AF_UNIX)
            try:
                probe.connect(sock_path)
                probe.close()
                raise RuntimeError("devserve already running at %s"
                                   % sock_path)
            except (ConnectionRefusedError, FileNotFoundError):
                os.unlink(sock_path)
            finally:
                probe.close()
        srv = socket.socket(socket.AF_UNIX)
        srv.bind(sock_path)
        srv.listen(8)
        print("# devserve: serving %s at %s" % (self.db, sock_path),
              file=sys.stderr, flush=True)
        if ready_cb is not None:
            ready_cb()
        ops = {"dense": self._op_dense, "chain": self._op_chain,
               "nw": self._op_nw, "pileup": self._op_pileup,
               "hello": self._op_hello, "stats": self._op_stats}
        # Each connection gets its own thread with per-frame deadlines,
        # so a peer that dies mid-frame (or connects and never speaks)
        # stalls only its own thread -- every other client keeps being
        # served.  Device work is serialized under op_lock (one backend
        # session); that's compute-bound, not peer-bound, so it cannot
        # wedge on a dead socket.  Reference role: kmapipe.c:241-253 --
        # the reference never hangs on a dead peer either.
        stop_ev = threading.Event()
        op_lock = threading.Lock()

        def handle(conn: socket.socket) -> None:
            # Reads and writes are decoupled: clients PIPELINE requests
            # (the native CLI keeps 2-3 slices in flight), so a handler
            # that blocks sending response k while the client is still
            # blocked sending request k+2 deadlocks both sides once the
            # socket buffers fill -- this was the r4 "-device on hung 25
            # minutes" wedge.  The reader thread only recvs + computes;
            # a writer thread drains the response queue in order.
            import queue as _q
            sendq: _q.Queue = _q.Queue()

            def writer():
                while True:
                    item = sendq.get()
                    if item is None:
                        return
                    try:
                        _send(conn, item[0], item[1])
                    except (OSError, ValueError):
                        # client gone or not reading (send deadline):
                        # drop the connection; the reader's recv fails
                        try:
                            conn.close()
                        except OSError:
                            pass
                        return

            wt = threading.Thread(target=writer, daemon=True)
            wt.start()
            # Cross-request device pipelining (opt-in via the request's
            # "pipeline" flag): a pipelined dense request is DISPATCHED
            # to the device immediately but its response is deferred
            # until the next request arrives -- so request k+1's upload
            # and dispatch overlap request k's device compute, matching
            # the in-process scanner's all-dispatch-then-sync shape.
            # The client ends the stream with a "flush" op.
            pending = []  # [(scanner, handle)] in request order

            def resolve_pending():
                while pending:
                    sc, h = pending.pop(0)
                    with op_lock:
                        try:
                            rm, ra = self._dense_pack(sc, h)
                        except Exception as e:
                            rm, ra = {"ok": 0, "err": repr(e)}, []
                    sendq.put((rm, ra))

            try:
                while not stop_ev.is_set():
                    try:
                        meta, arrays = _recv(conn, _IDLE_TIMEOUT,
                                             _FRAME_TIMEOUT)
                    except socket.timeout:
                        print("# devserve: dropping stalled client",
                              file=sys.stderr, flush=True)
                        return
                    op = meta.get("op")
                    if op in ("dense", "chain", "nw", "pileup"):
                        with op_lock:
                            self.served[op] = self.served.get(op, 0) + 1
                    if op == "dense" and meta.get("pipeline"):
                        try:
                            with op_lock:
                                sc_h = self._dense_dispatch(meta, arrays)
                        except Exception as e:
                            resolve_pending()
                            sendq.put(({"ok": 0, "err": repr(e)}, []))
                            continue
                        resolve_pending()
                        pending.append(sc_h)
                        continue
                    if op == "flush":
                        resolve_pending()
                        sendq.put(({"ok": 1}, []))
                        continue
                    resolve_pending()
                    if op == "stop":
                        sendq.put(({"ok": 1, "pid": os.getpid()}, []))
                        stop_ev.set()
                        # unblock accept() without relying on platform
                        # shutdown semantics
                        try:
                            poke = socket.socket(socket.AF_UNIX)
                            poke.settimeout(1.0)
                            poke.connect(sock_path)
                            poke.close()
                        except OSError:
                            pass
                        return
                    fn = ops.get(op)
                    if fn is None:
                        sendq.put(({"ok": 0, "err": "bad op %r" % op},
                                   []))
                        continue
                    try:
                        with op_lock:
                            if _PROF:
                                t0 = time.time()
                            rmeta, rarrays = fn(meta, arrays)
                            if _PROF:
                                print("# devserve prof: %s %.1f ms"
                                      % (op, 1e3 * (time.time() - t0)),
                                      file=sys.stderr, flush=True)
                    except Exception as e:  # keep the daemon alive
                        sendq.put(({"ok": 0, "err": repr(e)}, []))
                        continue
                    sendq.put((rmeta, rarrays))
            except (EOFError, ConnectionResetError, BrokenPipeError,
                    OSError):
                pass
            finally:
                sendq.put(None)
                wt.join(timeout=_FRAME_TIMEOUT + 5)
                try:
                    conn.close()
                except OSError:
                    pass

        threads: List[threading.Thread] = []
        while not stop_ev.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                break
            if stop_ev.is_set():
                conn.close()
                break
            t = threading.Thread(target=handle, args=(conn,),
                                 daemon=True)
            t.start()
            threads.append(t)
            threads = [t for t in threads if t.is_alive()]
        srv.close()
        for t in threads:
            t.join(timeout=5.0)
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        print("# devserve: stopped", file=sys.stderr)


# ---------------------------------------------------------------------------
# client


class DevClient:
    """Socket client for a running devserve daemon.

    Needs numpy + a unix socket only -- no jax import, so ``-device on``
    runs keep the light host interpreter startup.
    """

    def __init__(self, sock: socket.socket, k: int, db_size: int,
                 voff_map: np.ndarray):
        self._sock = sock
        self.k = k
        self.db_size = db_size
        self.voff_map = voff_map

    @classmethod
    def connect(cls, db_prefix: str,
                timeout: Optional[float] = None) -> Optional["DevClient"]:
        """Connect + identity handshake; None when no live daemon.

        The handshake deadline is SHORT (a healthy daemon answers hello
        in milliseconds; a wedged one must not stall the run).
        Subsequent calls run under a longer per-request deadline; a
        timeout raises and ends the run."""
        if timeout is None:
            timeout = float(os.environ.get("KMA_DEVSERVE_HELLO_TIMEOUT",
                                           15))
        path = os.environ.get("KMA_DEVSERVE_SOCKET") \
            or socket_path(db_prefix)
        if not os.path.exists(path):
            return None
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(timeout)
        try:
            s.connect(path)
            _send(s, {"op": "hello",
                      "db": os.path.realpath(db_prefix),
                      "sig": db_signature(db_prefix)})
            meta, arrays = _recv(s)
        except (OSError, EOFError):
            s.close()
            return None
        if not meta.get("ok"):
            print("# devserve: %s" % meta.get("err", "handshake failed"),
                  file=sys.stderr)
            s.close()
            return None
        return cls(s, int(meta["k"]), int(meta["db_size"]),
                   np.asarray(arrays["voff_map"], np.int64))

    #: per-request deadline; generous enough for a cold compile of one
    #: uncovered shape, bounded so a wedged daemon fails the run instead
    #: of hanging it
    CALL_TIMEOUT = float(os.environ.get("KMA_DEVSERVE_CALL_TIMEOUT", 300))

    def _call(self, meta: dict, arrays) -> Tuple[dict,
                                                 Dict[str, np.ndarray]]:
        self._sock.settimeout(self.CALL_TIMEOUT)
        _send(self._sock, meta, arrays)
        rmeta, rarrays = _recv(self._sock)
        if not rmeta.get("ok"):
            raise RuntimeError("devserve error: %s"
                               % rmeta.get("err", "?"))
        return rmeta, rarrays

    def dense_scan(self, codes: np.ndarray, lengths: np.ndarray,
                   pen, exhaustive: bool, proxi_frac):
        meta = {"op": "dense", "M": int(pen.M), "MM": int(pen.MM),
                "U": int(pen.U), "W1": int(pen.W1),
                "exhaustive": bool(exhaustive), "proxi_frac": proxi_frac}
        _, r = self._call(meta, [("codes", codes.astype(np.uint8)),
                                 ("lengths", lengths.astype(np.int32))])
        tid_lists = _unpack_tid_lists(r["has"], r["counts"],
                                      np.asarray(r["flat"], np.int32))
        return (np.asarray(r["scores"]), np.asarray(r["modes"]),
                tid_lists, np.asarray(r["over"]).astype(bool))

    def chain_lookup(self, codes: np.ndarray, lengths: np.ndarray):
        _, r = self._call({"op": "chain"},
                          [("codes", codes.astype(np.uint8)),
                           ("lengths", lengths.astype(np.int32))])
        return np.asarray(r["rows_f"]), np.asarray(r["rows_rc"])

    def nw_scores(self, t_len, q_len, kflag, hband, qext, tcol, *, dmat,
                  W1, U, MM):
        """Banded-NW scores from codes (ops/nw_kernel.nw_band_score)."""
        self.nw_scores_send(t_len, q_len, kflag, hband, qext, tcol,
                            dmat=dmat, W1=W1, U=U, MM=MM)
        return self.nw_scores_recv()

    def nw_scores_send(self, t_len, q_len, kflag, hband, qext, tcol, *,
                       dmat, W1, U, MM):
        """Fire-and-forget half of nw_scores (FIFO responses; the caller
        may pipeline sends -- the daemon's writer thread makes
        backpressure deadlock-free)."""
        meta = {"op": "nw", "W1": int(W1), "U": int(U), "MM": int(MM),
                "dmat": [[int(x) for x in row] for row in dmat]}
        arrays = [("t_len", np.asarray(t_len, np.int32)),
                  ("q_len", np.asarray(q_len, np.int32)),
                  ("kflag", np.asarray(kflag, np.int32)),
                  ("hband", np.asarray(hband, np.int32)),
                  ("qext", np.asarray(qext, np.uint8)),
                  ("tcol", np.asarray(tcol, np.uint8))]
        self._sock.settimeout(self.CALL_TIMEOUT)
        _send(self._sock, meta, arrays)

    def nw_scores_recv(self):
        self._sock.settimeout(self.CALL_TIMEOUT)
        rmeta, r = _recv(self._sock)
        if not rmeta.get("ok"):
            raise RuntimeError("devserve error: %s"
                               % rmeta.get("err", "?"))
        return np.asarray(r["scores"])

    def stats(self) -> Dict[str, int]:
        """Requests served per op since the daemon started."""
        rmeta, _ = self._call({"op": "stats"}, [])
        return {k: int(v) for k, v in rmeta["served"].items()}

    def pileup(self, t_flat, q_flat, offs, starts, t_len: int):
        """Dense assembly count scatter on the device (ops/pileup.py);
        returns the [t_len, 6] i64 delta matrix."""
        _, r = self._call(
            {"op": "pileup", "t_len": int(t_len)},
            [("t_flat", np.asarray(t_flat, np.uint8)),
             ("q_flat", np.asarray(q_flat, np.uint8)),
             ("offs", np.asarray(offs, np.int64)),
             ("starts", np.asarray(starts, np.int32))])
        return np.asarray(r["delta"], np.int64)

    def stop(self) -> Optional[int]:
        """Ask the daemon to shut down; returns its pid (None when it
        closed the connection without saying)."""
        _send(self._sock, {"op": "stop"})
        try:
            meta, _ = _recv(self._sock)
        except EOFError:
            meta = {}
        self.close()
        return meta.get("pid")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteDenseScanner:
    """DenseScanner.scan_reads duck-type backed by a devserve daemon
    (scan_stream.DeviceScanStream's ``dense`` slot)."""

    def __init__(self, client: DevClient, pen, exhaustive: bool,
                 proxi_frac):
        self.client = client
        self.pen = pen
        self.exhaustive = exhaustive
        self.proxi_frac = proxi_frac

    def scan_reads(self, codes: np.ndarray, lengths: np.ndarray):
        return self.client.dense_scan(codes, lengths, self.pen,
                                      self.exhaustive, self.proxi_frac)


# ---------------------------------------------------------------------------
# CLI


#: seconds ``devserve -stop`` waits for the daemon process to exit
STOP_TIMEOUT = 60.0


def _exited(pid: int) -> bool:
    """True once process ``pid`` is gone, or is a zombie none of whose
    threads still runs (its parent has yet to reap it).  A zombie main
    thread alone is not enough: the device runtime's threads go on
    tearing the device session down after it."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    try:
        with open("/proc/%d/stat" % pid) as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state == "Z" and len(os.listdir("/proc/%d/task" % pid)) <= 1
    except FileNotFoundError:
        return os.path.isdir("/proc")  # gone since os.kill (or no /proc)


def _wait_exit(pid: int, timeout: float) -> bool:
    """Wait until process ``pid`` has exited (see _exited); False on
    timeout."""
    deadline = time.time() + timeout
    while not _exited(pid):
        if time.time() >= deadline:
            return False
        time.sleep(0.1)
    return True


def devserve_main(argv: List[str]) -> int:
    """``kma devserve -t_db DB [-b] [-stop] [-warm L1,L2,..] [-batch N]``.

    -b daemonizes (double fork); -stop shuts a running daemon down.
    """
    db = None
    bg = False
    stop = False
    warm_lens = [128]
    batch = 2048
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-t_db":
            i += 1
            db = argv[i]
        elif a == "-b":
            bg = True
        elif a == "-stop":
            stop = True
        elif a == "-warm":
            i += 1
            warm_lens = [int(x) for x in argv[i].split(",") if x]
        elif a == "-batch":
            i += 1
            batch = int(argv[i])
        elif a in ("-h", "--help"):
            print(devserve_main.__doc__)
            return 0
        else:
            print("# Invalid option:\t%s" % a, file=sys.stderr)
            return 1
        i += 1
    if db is None:
        print("devserve needs -t_db", file=sys.stderr)
        return 1
    if stop:
        cli = DevClient.connect(db)
        if cli is None:
            print("# devserve: no daemon for %s" % db, file=sys.stderr)
            return 1
        pid = cli.stop()
        # return only once the daemon has exited and released the card,
        # so a device run started right after -stop finds it free
        if pid is not None and not _wait_exit(int(pid), STOP_TIMEOUT):
            print("# devserve: daemon pid %d still running %.0f s after "
                  "stop" % (pid, STOP_TIMEOUT), file=sys.stderr)
            return 1
        print("# devserve: stopped daemon for %s" % db, file=sys.stderr)
        return 0
    # harness guard: when KMA_DEVSERVE_EXIT_WITH names a pid, exit when
    # that process dies -- a daemon spawned by a test runner or a check
    # script must not outlive it even if it is SIGKILLed midway
    watch = os.environ.get("KMA_DEVSERVE_EXIT_WITH")
    if watch:
        def _watchdog(pid=int(watch)):
            while True:
                time.sleep(1)
                try:
                    os.kill(pid, 0)
                except OSError:
                    os._exit(0)
        threading.Thread(target=_watchdog, daemon=True).start()
    # refuse duplicates BEFORE the expensive scanner build/warm
    # (a check after warm-up would pay the whole compile first),
    # and sweep sockets left by dead daemons while we are here
    reap_stale_sockets()
    if probe_live(db):
        print("# devserve: already running for %s" % db, file=sys.stderr)
        return 1
    if bg:
        # double-fork daemonization; the child signals readiness (socket
        # bound, shapes warm) through a pipe so `kma devserve -b` returns
        # only when clients can connect
        r, w = os.pipe()
        pid = os.fork()
        if pid:
            os.close(w)
            msg = os.read(r, 64)
            os.close(r)
            os.waitpid(pid, 0)  # the first child exits right after forking
            if msg.startswith(b"ready"):
                print("# devserve: daemon ready (pid %s)"
                      % msg.split()[1].decode(), file=sys.stderr)
                return 0
            print("# devserve: daemon failed to start", file=sys.stderr)
            return 1
        os.close(r)
        os.setsid()
        pid2 = os.fork()
        if pid2:
            os._exit(0)
        devnull = os.open(os.devnull, os.O_RDWR)
        os.dup2(devnull, 0)
        log = os.environ.get("KMA_DEVSERVE_LOG")
        if log:
            fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o600)
            os.dup2(fd, 1)
            os.dup2(fd, 2)
        else:
            os.dup2(devnull, 1)
            os.dup2(devnull, 2)

        def ready():
            os.write(w, b"ready %d" % os.getpid())
            os.close(w)

        try:
            srv = DevServer(db, batch=batch)
            srv.warm(warm_lens)
            srv.serve(ready_cb=ready)
        except Exception:
            try:
                os.close(w)
            except OSError:
                pass
            raise
        return 0
    srv = DevServer(db, batch=batch)
    srv.warm(warm_lens)
    srv.serve()
    return 0

"""Run-scoring kernel parity (ops/scan_kernel.py, Pallas interpret mode).

The kernel, which keeps each tile's state in registers through the whole
run loop, must produce the same scan results as both the plain XLA
chunked loop and the host-exact scanner."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kma_tpu.config import Penalties

from test_dense_scan import tiny_db, read_batch, _host_expect  # noqa: F401


def _mk_scanner(idx, pen, mode, batch):
    from kma_tpu.mapping.scan_dense import DenseScanner
    sc = DenseScanner(idx, pen, batch=batch)
    sc.kernel_mode = mode
    return sc


def test_pallas_matches_xla_and_host(tiny_db, read_batch):  # noqa: F811
    idx, _ = tiny_db
    codes, lengths = read_batch
    pen = Penalties()
    pen.score_matrix()
    xla = _mk_scanner(idx, pen, None, 32)
    pal = _mk_scanner(idx, pen, "interpret", 32)
    sx = xla.scan_reads(codes, lengths)
    sp = pal.scan_reads(codes, lengths)
    assert sx[0].tolist() == sp[0].tolist()          # scores
    assert sx[1].tolist() == sp[1].tolist()          # modes
    assert sx[3].tolist() == sp[3].tolist()          # overflow
    for a, b in zip(sx[2], sp[2]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.tolist() == b.tolist()
    expected = _host_expect(idx, pen, codes, lengths)
    scores, modes, tid_lists, over = sp
    for i, exp in enumerate(expected):
        if over[i]:
            continue
        if exp is None:
            assert modes[i] == 0
            continue
        assert scores[i] == exp.rc_flag, f"read {i} score"
        assert tid_lists[i].tolist() == exp.templates.tolist(), f"read {i}"


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu, tiny_db, read_batch):  # noqa: F811
    """The Triton-compiled kernel equals the plain XLA loop on the card."""
    idx, _ = tiny_db
    codes, lengths = read_batch
    pen = Penalties()
    pen.score_matrix()
    sk = _mk_scanner(idx, pen, "compiled", 32).scan_reads(codes, lengths)
    sx = _mk_scanner(idx, pen, None, 32).scan_reads(codes, lengths)
    assert sk[0].tolist() == sx[0].tolist()
    assert sk[1].tolist() == sx[1].tolist()
    for a, b in zip(sk[2], sx[2]):
        assert (a is None) == (b is None)
        assert a is None or a.tolist() == b.tolist()

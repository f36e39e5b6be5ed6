"""One rule picks the device implementation: the platform (ops/platform.py).

gpu -> the hand-written kernels, cpu -> their plain versions, anything
else -> refused; no environment variable has a say.  Also the
compile-cache rule of the package (kma_tpu/__init__.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from kma_tpu.config import Penalties
from kma_tpu.ops import nw_kernel, platform
from kma_tpu.ops.nw_kernel import nw_band_score, stage_code_inputs

from tests.test_dense_scan import tiny_db  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nw_case(L=None):
    rng = np.random.default_rng(1)
    ts = [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(4)]
    qs = [t.copy() for t in ts]
    tl, ql, hb, qext, tcol = stage_code_inputs(ts, qs, [40] * 4, [40] * 4,
                                               64, L=L)
    pen = Penalties()
    DMAT = tuple(tuple(int(x) for x in row)
                 for row in pen.score_matrix()[:5, :5])
    return (tl, ql, np.zeros(4, np.int32), hb, qext, tcol), dict(
        DMAT=DMAT, W1=pen.W1, U=pen.U, MM=pen.MM)


class _EnvTripwire(dict):
    """os.environ stand-in that records every key read."""

    def __init__(self, base):
        super().__init__(base)
        self.read = []

    def get(self, key, default=None):
        self.read.append(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.read.append(key)
        return super().__getitem__(key)

    def __contains__(self, key):
        self.read.append(key)
        return super().__contains__(key)


@pytest.mark.parametrize("prebuilt", [False, True])
def test_cpu_takes_plain_versions(tiny_db, monkeypatch, prebuilt):  # noqa: F811
    """On the CPU both scorers take their plain versions, and no
    environment variable of the program takes part in the choice."""
    from kma_tpu.mapping.scan_dense import DenseIndex, DenseScanner
    idx, _ = tiny_db
    didx = DenseIndex.from_host(idx) if prebuilt else None
    env = _EnvTripwire(os.environ)
    monkeypatch.setattr(os, "environ", env)
    assert jax.default_backend() == "cpu"
    assert platform.use_kernels() is False
    sc = DenseScanner(idx, Penalties(), batch=32, didx=didx)
    assert sc.kernel_mode is None
    calls = []
    real = nw_kernel.nw_band_score_plain
    monkeypatch.setattr(nw_kernel, "nw_band_score_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args, kw = _nw_case()
    assert np.asarray(nw_band_score(*args, **kw)).tolist() == [40 * 1] * 4
    assert calls == [1]
    # none of this program's variables is consulted (jax reads its own)
    ours = {k for k in env.read if k.startswith("KMA")}
    assert not ours, ours


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(tiny_db, monkeypatch, backend):  # noqa: F811
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="no device implementation"):
        platform.use_kernels()
    args, kw = _nw_case()
    with pytest.raises(RuntimeError):
        nw_band_score(*args, **kw)
    from kma_tpu.mapping.scan_dense import DenseScanner
    idx, _ = tiny_db
    with pytest.raises(RuntimeError):
        DenseScanner(idx, Penalties(), batch=32)


def test_gpu_takes_kernels(tiny_db, monkeypatch):  # noqa: F811
    """On a GPU the dense scanner selects the run-scoring kernel, its
    batch must fill whole row tiles, and the NW wrapper refuses a lane
    width the CUDA kernel has no instance for (before any build)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.use_kernels() is True
    from kma_tpu.mapping.scan_dense import DenseScanner
    idx, _ = tiny_db
    assert DenseScanner(idx, Penalties(), batch=32).kernel_mode \
        == "compiled"
    with pytest.raises(ValueError, match="multiple of 8"):
        DenseScanner(idx, Penalties(), batch=12)
    args, kw = _nw_case(L=384)
    monkeypatch.setattr(nw_kernel, "_register_cuda",
                        lambda: pytest.fail("built for a bad width"))
    with pytest.raises(ValueError, match="lane width 384"):
        nw_band_score(*args, **kw)


def _cache_dir(env, pre=""):
    r = subprocess.run(
        [sys.executable, "-c", pre + "import kma_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip()


@pytest.mark.parametrize("jax_first", [False, True])
def test_compile_cache_rule(tmp_path, jax_first):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    <repo>/.cache/jax, whether or not jax was imported first."""
    pre = "import jax; " if jax_first else ""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert _cache_dir(env, pre) == os.path.join(REPO, ".cache", "jax")
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    assert _cache_dir(env, pre) == str(tmp_path / "cc")

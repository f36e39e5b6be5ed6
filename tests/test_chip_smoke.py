"""chip_smoke.py's own contract on a machine without a GPU: it fails
without printing a result, and it stops every process it leaves behind."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_fails_without_gpu_or_program(where, tmp_path):
    """Held to the CPU, or copied alone into an empty directory, the
    script exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script), "--work",
                        str(tmp_path / "work")], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "chip_smoke" in r.stderr


def test_stop_descendants_reaps_orphans(tmp_path):
    """A grandchild orphaned by its parent (as the devserve daemon is by
    its launcher) is adopted, then stopped and reaped."""
    prog = """
import json, os, subprocess, sys, time
sys.path.insert(0, %r)
import chip_smoke
chip_smoke.adopt_orphans()
subprocess.run(["sh", "-c", "sleep 300 > /dev/null 2>&1 & echo $! > %s"])
pid = int(open(%r).read())
deadline = time.time() + 10
while pid not in chip_smoke._children() and time.time() < deadline:
    time.sleep(0.05)
adopted = pid in chip_smoke._children()
left = chip_smoke.stop_descendants(grace=5)
try:
    os.kill(pid, 0)
    gone = False
except ProcessLookupError:
    gone = True
print(json.dumps({"pid": pid, "adopted": adopted, "left": left,
                  "gone": gone, "children": chip_smoke._children()}))
""" % (str(REPO), tmp_path / "pid", str(tmp_path / "pid"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["adopted"], got
    assert got["left"] == [got["pid"]], got
    assert got["gone"] and got["children"] == {}, got

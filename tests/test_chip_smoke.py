"""chip_smoke.py refuses to report without a GPU and without the repo."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs GPUs" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it fails before printing any result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

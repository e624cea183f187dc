"""The PyTorch port imports neither jax nor the JAX package: every module of
multiview_tpu_torch is imported in a subprocess in which both are made
unimportable."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "multiview_tpu"):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, Block())
import multiview_tpu_torch
names = [m.name for m in pkgutil.walk_packages(multiview_tpu_torch.__path__,
                                                 "multiview_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "multiview_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_chip_smoke_refuses_to_run_without_a_gpu_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result on a machine with no
    CUDA device, and in a directory holding nothing else of the repo."""
    import torch
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                                   capture_output=True, text=True, timeout=120))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout

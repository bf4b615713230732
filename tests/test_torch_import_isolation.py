"""The PyTorch/CUDA port and chip_smoke.py import nothing of JAX and nothing
of the JAX package: a fresh interpreter imports every module of the port
(models/clip and data among them), and chip_smoke.py as a module, behind a
finder that refuses jax, jaxlib, flax and the exact package
transductive_clip_tpu — and PIL, which the port imports only when it
decodes an image."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib
import importlib.abc
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "transductive_clip_tpu", "PIL")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, Refuse())
import transductive_clip_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names), "modules")
"""


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n = int(out.stdout.split("imported")[1].split()[0])
    # every subpackage and module of the zero-shot, few-shot and extraction
    # slices
    assert n >= 57, out.stdout

"""The PyTorch/CUDA port, chip_smoke.py and the port's scripts import
nothing of JAX and nothing of the JAX package: a fresh interpreter imports
every module of the port (models/clip and data among them), and
chip_smoke.py as a module, behind a finder that refuses jax, jaxlib, flax
and the exact package transductive_clip_tpu — and PIL, which the port
imports only when it decodes an image; another imports every
scripts/*_torch.py (and the tests/torch_clip.py oracle that
validate_checkpoint_torch.py reads) behind the same finder. The
scripts/*_torch.sh runners call the port's CLI, never main.py."""

import glob

import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib
import os
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
if os.environ.get("PROBE_SCRIPTS"):
    sys.path[:0] = ["scripts", "tests"]
    names = os.environ["PROBE_SCRIPTS"].split(",") + ["torch_clip"]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("imported", len(names), "modules")
    sys.exit(0)
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


def test_port_scripts_import_no_jax():
    scripts = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(REPO, "scripts", "*_torch.py")))
    assert scripts == ["convert_feature_cache_torch",
                       "run_synthetic_protocol_torch",
                       "validate_checkpoint_torch"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               PROBE_SCRIPTS=",".join(scripts))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "imported 4 modules" in out.stdout, out.stdout
    runners = sorted(glob.glob(os.path.join(REPO, "scripts", "*_torch.sh")))
    assert len(runners) == 5
    for path in runners:
        text = open(path).read()
        assert "main.py" not in text and "transductive_clip_tpu/" not in text
        assert "-m transductive_clip_tpu_torch.cli --opts" in text, path

"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``_build/`` beside this package (listed in .gitignore),
keyed by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is reused. ``build`` starts one ``nvcc`` per missing source,
all at once. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# every kernel source of the port; chip_smoke.py builds them all together
SOURCES = ("dirichlet_solve.cu", "tim_support_grad.cu")
# no --use_fast_math: the parity of the kernels with their plain versions
# rests on IEEE fp32 division, logf and expf; -Xptxas -v reports each
# kernel's registers, shared memory and spills into ``build_log``
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 900

#: source name -> the compiler's output of its last build in this process
build_log: dict = {}
_loaded: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "with nvcc on the machine that holds the card"
    )


def library_path(source: str) -> Path:
    """Where the library built from ``source`` lives, keyed by the contents
    of the source, of every header in csrc/, and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> None:
    """Compile every source whose library is missing, one ``nvcc`` process
    each, all started together. Raises with the compiler's output if any
    fails."""
    todo = [(s, library_path(s)) for s in sources]
    todo = [(s, out) for s, out in todo if not out.exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, out, tmp, proc))
    failed = []
    for source, out, tmp, proc in running:
        try:
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {_BUILD_TIMEOUT_S} s"
        build_log[source] = log
        if proc.returncode == 0:
            os.replace(tmp, out)    # atomic: a concurrent build never sees half a file
        else:
            failed.append(f"--- {source} (nvcc exit {proc.returncode}) ---\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """The loaded library built from ``source`` (built first if missing)."""
    lib = _loaded.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(library_path(source)))
        _loaded[source] = lib
    return lib

"""Build, load, bind and launch the port's native libraries.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``_build/`` beside this package (listed in .gitignore),
keyed by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is reused. ``build`` starts one ``nvcc`` per missing source,
all at once. ``host_library`` does the same for a C++ source of the host
(``native/lapjv.cpp``) with ``g++``. Nothing here runs when the module is
imported.

Every kernel wrapper (``ops/cuda_*.py``) goes through one seam: it declares
its entry points' C arguments in a signature table, ``load`` binds them once
a source, and ``launch`` calls one on the current stream of a tensor's
device and raises on the CUDA error it returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# every kernel source of the port, and special_check.cu, which checks the
# Dirichlet kernels' arithmetic; chip_smoke.py builds them all together
SOURCES = ("dirichlet_solve.cu", "tim_support_grad.cu", "attention.cu",
           "bottleneck.cu", "auction.cu", "newton_minka.cu", "avg_pool.cu",
           "quick_gelu.cu", "add_layer_norm.cu", "special_check.cu")
# no --use_fast_math: the parity of the kernels with their plain versions
# rests on IEEE fp32 division, logf and expf; -Xptxas -v reports each
# kernel's registers, shared memory and spills into ``build_log``
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 900
# the host compiler's flags for host_library (as the JAX package builds its
# LAP solver)
HOST_FLAGS = ("-O2", "-shared", "-fPIC")

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


def host_library(source: Path) -> Path:
    """The shared library of the host C++ file ``source``, compiled by
    ``g++`` with HOST_FLAGS into ``_build/`` at first use, keyed by the
    contents of the file and the flags. Raises with the compiler's output
    if the build fails."""
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    digest.update(source.read_bytes())
    out = BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        raise RuntimeError("no host C++ compiler (g++) on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([compiler, *HOST_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed on {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


#: the letters of a signature table: a pointer (a tensor's ``data_ptr()``,
#: None or the stream), a C int, a C ``long long`` (an element count past
#: 2^31), a C float; spaces only group them
ARG_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "l": ctypes.c_longlong, "f": ctypes.c_float}


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """The library built from ``source`` (built first if missing), each
    entry point of ``signatures`` bound: name -> its C arguments in
    ``ARG_TYPES`` letters, the stream last; every entry point returns an
    int, 0 or a ``cudaError_t``. Loaded and bound once a source."""
    lib = _loaded.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(library_path(source)))
        for name, letters in signatures.items():
            entry = getattr(lib, name)
            entry.argtypes = [ARG_TYPES[c] for c in letters.replace(" ", "")]
            entry.restype = ctypes.c_int
        _loaded[source] = lib
    return lib


def error_string(code: int) -> str:
    """The CUDA runtime's text for the ``cudaError_t`` ``code``."""
    cudart = torch.cuda.cudart()
    return cudart.cudaGetErrorString(cudart.cudaError(code))


def launch(entry, device: torch.device, *args) -> None:
    """Calls the bound entry point ``entry(*args, stream)`` with the
    current stream of CUDA ``device``, inside that device's context when
    another device is current; raises RuntimeError naming the entry point
    and the CUDA error when it returns non-zero. Adds no host work beyond
    the current-device check and the stream lookup: the Newton-Minka step
    calls this hundreds of times a zero-shot batch."""
    index = device.index
    if index == torch.cuda.current_device():
        rc = entry(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = entry(*args, torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__}: kernel launch failed: "
                           f"{error_string(rc)} (cuda error {rc})")

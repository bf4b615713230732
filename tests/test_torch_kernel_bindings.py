"""The seam through which every kernel wrapper binds and launches its CUDA
entry points (``ops/kernel_build.py``): each wrapper's signature table
against the C prototype in its ``csrc/`` source, read as text (a pointer,
an int, a long long or a float in each place; on the CPU no wrapper
reaches the card, so only this holds a table to its source), every
exported entry point bound by exactly one table, and ``load`` and
``launch`` against fakes of the library and of the CUDA runtime: the
letters bound as ctypes types, the stream passed last, the device's
context entered only when another device is current, and a non-zero
return raised as an error that names the entry point."""

import contextlib
import ctypes
import re
import types

import pytest
import torch

from transductive_clip_tpu_torch.ops import cuda_add_norm
from transductive_clip_tpu_torch.ops import cuda_attention
from transductive_clip_tpu_torch.ops import cuda_auction
from transductive_clip_tpu_torch.ops import cuda_bottleneck
from transductive_clip_tpu_torch.ops import cuda_dirichlet
from transductive_clip_tpu_torch.ops import cuda_gelu
from transductive_clip_tpu_torch.ops import cuda_newton
from transductive_clip_tpu_torch.ops import cuda_pool
from transductive_clip_tpu_torch.ops import cuda_tim
from transductive_clip_tpu_torch.ops import dirichlet_fixtures
from transductive_clip_tpu_torch.ops import kernel_build

#: every entry point a wrapper calls -> the module whose table binds it
ENTRIES = {
    "tclip_dirichlet_row_solve": cuda_dirichlet,
    "tclip_mm_row_solve": cuda_dirichlet,
    "tclip_tim_support_grad": cuda_tim,
    "tclip_attention_rows": cuda_attention,
    "tclip_attention_blocked": cuda_attention,
    "tclip_bottleneck": cuda_bottleneck,
    "tclip_auction": cuda_auction,
    "tclip_newton_minka_step": cuda_newton,
    "tclip_newton_minka_final": cuda_newton,
    "tclip_avg_pool": cuda_pool,
    "tclip_quick_gelu": cuda_gelu,
    "tclip_add_layer_norm": cuda_add_norm,
    "tclip_special_check": dirichlet_fixtures,
}


def _prototype(source: str, name: str) -> str:
    """The C arguments of ``name`` in ``source`` as signature letters."""
    text = (kernel_build.CSRC / source).read_text()
    found = re.findall(rf"\bint {name}\(([^)]*)\)\s*\{{", text)
    assert len(found) == 1, f"{name}: {len(found)} definitions in {source}"
    letters = []
    for param in found[0].split(","):
        words = param.replace("*", " * ").split()
        if "*" in words:
            letters.append("p")
        else:
            letters.append({"int": "i", "long": "l", "float": "f"}[words[-2]])
    return "".join(letters)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_signature_table_matches_the_c_prototype(name):
    module = ENTRIES[name]
    assert module.SOURCE in kernel_build.SOURCES
    letters = module.SIGNATURES[name].replace(" ", "")
    assert set(letters) <= set(kernel_build.ARG_TYPES)
    assert letters == _prototype(module.SOURCE, name)
    assert letters.endswith("p")    # the stream, which launch adds


def test_every_export_is_bound_by_one_table():
    exported = set()
    for source in kernel_build.SOURCES:
        text = (kernel_build.CSRC / source).read_text()
        exported |= set(re.findall(r"^(?:extern \"C\" )?int (tclip_\w+)\(",
                                   text, re.M))
    assert exported == set(ENTRIES)
    for module in set(ENTRIES.values()):
        assert {n for n, m in ENTRIES.items() if m is module} == set(
            module.SIGNATURES)


def test_load_binds_each_table_once_a_source(monkeypatch):
    class FakeLibrary:
        opened = 0

        def __init__(self, path):
            FakeLibrary.opened += 1
            self.tclip_a = types.SimpleNamespace()
            self.tclip_b = types.SimpleNamespace()

    monkeypatch.setattr(kernel_build, "build", lambda sources: None)
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", FakeLibrary)
    monkeypatch.setattr(kernel_build, "_loaded", {})
    table = {"tclip_a": "pp i f p", "tclip_b": "ip"}
    lib = kernel_build.load("auction.cu", table)
    assert lib.tclip_a.argtypes == [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_float,
                                    ctypes.c_void_p]
    assert lib.tclip_b.argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert lib.tclip_a.restype is ctypes.c_int
    assert kernel_build.load("auction.cu", table) is lib
    assert FakeLibrary.opened == 1


def test_load_binds_a_long_long_as_64_bits(monkeypatch):
    """``l``, an element count past 2^31 (QuickGELU's hidden at batch 512
    is 1.21e9 elements), binds as a C ``long long``, not an int."""

    class FakeLibrary:
        def __init__(self, path):
            self.tclip_c = types.SimpleNamespace()

    monkeypatch.setattr(kernel_build, "build", lambda sources: None)
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", FakeLibrary)
    monkeypatch.setattr(kernel_build, "_loaded", {})
    lib = kernel_build.load("quick_gelu.cu", {"tclip_c": "pp l i p"})
    assert lib.tclip_c.argtypes == [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]
    assert ctypes.sizeof(lib.tclip_c.argtypes[2]) == 8


class _FakeCuda:
    """torch.cuda as launch sees it: ``current`` is the current device,
    ``entered`` the devices whose context was entered."""

    def __init__(self, monkeypatch, current):
        self.current, self.entered = current, []
        monkeypatch.setattr(torch.cuda, "current_device", lambda: self.current)
        monkeypatch.setattr(
            torch.cuda, "current_stream",
            lambda index: types.SimpleNamespace(cuda_stream=1000 + index))
        monkeypatch.setattr(torch.cuda, "device", self._device)
        monkeypatch.setattr(torch.cuda, "cudart", lambda: types.SimpleNamespace(
            cudaError=int,
            cudaGetErrorString=lambda code: {1: "invalid argument"}[code]))

    @contextlib.contextmanager
    def _device(self, index):
        self.entered.append(index)
        yield


@pytest.mark.parametrize("current", [1, 0], ids=["current", "other"])
def test_launch_passes_the_stream_of_the_tensors_device(monkeypatch,
                                                        current):
    cuda = _FakeCuda(monkeypatch, current)
    calls = []

    def tclip_fake(*args):
        calls.append(args)
        return 0

    kernel_build.launch(tclip_fake, torch.device("cuda", 1), 7, None, 2.5)
    assert calls == [(7, None, 2.5, 1001)]
    assert cuda.entered == ([] if current == 1 else [1])


def test_launch_raises_naming_the_entry_point(monkeypatch):
    _FakeCuda(monkeypatch, 0)

    def tclip_fake(*args):
        return 1

    with pytest.raises(RuntimeError, match=r"^tclip_fake: kernel launch "
                       r"failed: invalid argument \(cuda error 1\)$"):
        kernel_build.launch(tclip_fake, torch.device("cuda", 0), 3)


@pytest.mark.cuda
def test_refused_launch_raises_the_cuda_error_on_card():
    """A launch the C side refuses (a negative Newton iteration count)
    raises through the seam with the runtime's text for the error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    s = torch.ones((2, 3), device="cuda")
    y = torch.full((2, 3, 5), -1.0, device="cuda")
    done = torch.tensor(False, device="cuda")
    launches = cuda_newton.newton_minka_step.launches
    with pytest.raises(RuntimeError, match=r"^tclip_newton_minka_step: "
                       r"kernel launch failed: invalid argument \(cuda "
                       r"error 1\)$"):
        cuda_newton.newton_minka_step(s, y, None, done, newton_iters=-1)
    assert cuda_newton.newton_minka_step.launches == launches

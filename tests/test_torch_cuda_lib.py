"""The seam every hand-written CUDA kernel goes through (ops/cuda_lib.py), on the CPU.

Each declared kernel launched against a fake library (no card here: the
device guard and the current stream are replaced too): a refused launch
raises naming the kernel and counts nothing, an accepted one counts exactly
one launch under the kernel's name, or under `count_as`. The declarations
against the C signatures in csrc/*.cu, parameter for parameter. The build's
key and file names, without running nvcc. The kernels themselves run on the
card (tests/test_torch_cuda.py, test_torch_epilogue_cuda.py,
test_torch_conv3x3_cuda.py, test_torch_pack_cuda.py).
"""

import contextlib
import ctypes
import hashlib
import re
import types

import pytest
import torch

from geomconsistentfr_torch.ops import conv3x3_cuda, cuda_lib, epilogue_cuda, pack_cuda, shadows_cuda

LIBRARIES = {"march": shadows_cuda.LIBRARY, "epilogue": epilogue_cuda.LIBRARY, "conv3x3": conv3x3_cuda.LIBRARY,
             "pack": pack_cuda.LIBRARY}
DECLARED = [(lib, kernel) for lib, library in LIBRARIES.items() for kernel in library.kernels]
CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def test_launches_holds_every_declared_kernel():
    assert sorted(cuda_lib.LAUNCHES) == sorted(["stage", "march", "march_argmin", "refine", "march_grad", "march_sp",
                                                "unpack_key", "epilogue", "conv3x3", "pack"])
    assert sorted(k for _, k in DECLARED) == sorted(cuda_lib.LAUNCHES)


@pytest.fixture
def fake_card(monkeypatch):
    """No CUDA device guard and a stream handle of 0; returns fake(library, code), which
    swaps the library's entry points for ones that record their arguments and return `code`."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(cuda_stream=0))
    calls = []

    def fake(library, code):
        entry = lambda *args: calls.append(args) or code  # noqa: E731
        monkeypatch.setattr(library, "load", lambda: dict.fromkeys(library.kernels, entry))
        return calls

    return fake


@pytest.mark.parametrize("lib,kernel", DECLARED, ids=[f"{lib}.{k}" for lib, k in DECLARED])
def test_refused_launch_raises_and_counts_nothing(fake_card, lib, kernel):
    library = LIBRARIES[lib]
    calls = fake_card(library, 2)
    before = dict(cuda_lib.LAUNCHES)
    with pytest.raises(RuntimeError, match=f"^{kernel} kernel launch failed: CUDA error 2$"):
        library.launch(kernel, torch.device("cuda", 0), 11, 12)
    assert cuda_lib.LAUNCHES == before
    assert calls == [(11, 12, 0)]  # the kernel's arguments, then the stream


@pytest.mark.parametrize("lib,kernel", DECLARED, ids=[f"{lib}.{k}" for lib, k in DECLARED])
def test_accepted_launch_counts_one_under_its_name(fake_card, lib, kernel):
    library = LIBRARIES[lib]
    fake_card(library, 0)
    before = dict(cuda_lib.LAUNCHES)
    library.launch(kernel, torch.device("cuda", 0), 11, 12)
    assert {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items() if v != before[k]} == {kernel: 1}


def test_count_as_counts_under_its_name_and_a_refusal_names_the_kernel(fake_card):
    library, dev = shadows_cuda.LIBRARY, torch.device("cuda", 0)
    fake_card(library, 0)
    before = dict(cuda_lib.LAUNCHES)
    library.launch("march_argmin", dev, count_as="march_sp")
    assert {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items() if v != before[k]} == {"march_sp": 1}
    fake_card(library, 700)
    with pytest.raises(RuntimeError, match="^march_argmin kernel launch failed: CUDA error 700$"):
        library.launch("march_argmin", dev, count_as="march_sp")
    assert cuda_lib.LAUNCHES["march_sp"] == before["march_sp"] + 1


def c_signatures(source) -> dict:
    """Each `extern "C" int name(...)` of a source: its parameters as ctypes types."""
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{', source.read_text(), re.S):
        types_ = []
        for p in params.split(","):
            words = p.split()[:-1]  # the type, without the parameter's name
            types_.append(ctypes.c_void_p if "*" in p else CTYPES[" ".join(w for w in words if w != "const")])
        found[name] = types_
    return found


@pytest.mark.parametrize("lib", sorted(LIBRARIES))
def test_declarations_match_the_c_signatures(lib):
    """Each declared entry point exists in the source, and its argtypes and the trailing stream
    are the C function's parameters, type for type."""
    library = LIBRARIES[lib]
    signatures = c_signatures(library.source)
    for kernel, (entry, argtypes) in library.kernels.items():
        assert entry in signatures, (kernel, entry)
        assert [*argtypes, ctypes.c_void_p] == signatures[entry], (kernel, entry)


def test_build_key_follows_the_source_and_the_flags(tmp_path, monkeypatch):
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("extern \"C\" int f() { return 0; }\n")
    b.write_text("extern \"C\" int f() { return 0; }\n")
    key = cuda_lib.build_key(a)
    assert cuda_lib.build_key(b) == key  # the same source and flags
    assert key == hashlib.sha256(a.read_bytes() + " ".join(cuda_lib.NVCC_FLAGS).encode()).hexdigest()[:16]
    b.write_text("extern \"C\" int f() { return 1; }\n")
    assert cuda_lib.build_key(b) != key
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS", cuda_lib.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_lib.build_key(a) != key


def test_build_loads_an_existing_build_without_nvcc(tmp_path, monkeypatch):
    """An existing `<stem>_<key>.so` in the build directory is the build: nvcc does not run."""
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: pytest.fail("nvcc ran"))
    key = cuda_lib.build_key(source)
    (tmp_path / "kernels").mkdir()
    (tmp_path / "kernels" / f"k_{key}.so").write_bytes(b"")
    (tmp_path / "kernels" / f"k_{key}.log").write_text("ptxas info")
    assert cuda_lib.build(source) == (tmp_path / "kernels" / f"k_{key}.so", "ptxas info")


@pytest.mark.parametrize("case", ["device", "dtype", "shape", "order", "aligned"])
def test_check_refuses_what_a_kernel_does_not_read(case):
    t = torch.zeros(2, 3, 4, 5)
    args = dict(name="x", t=t, shape=(2, 3, 4, 5), device=torch.device("cpu"))
    error, match = {
        "device": (dict(device=torch.device("meta")), "x is on cpu, expected meta"),
        "dtype": (dict(t=t.double()), "x must be float32, got torch.float64"),
        "shape": (dict(shape=(2, 3, 4, 4)), r"x has shape \(2, 3, 4, 5\), expected \(2, 3, 4, 4\)"),
        "order": (dict(fmt=torch.channels_last), "memory order"),
        "aligned": (dict(t=torch.zeros(1 + 120)[1:].view(2, 3, 4, 5), aligned=True), "16-byte aligned"),
    }[case]
    cuda_lib.check(**args)  # the unchanged arguments pass
    with pytest.raises(TypeError if case == "dtype" else ValueError, match=match):
        cuda_lib.check(**dict(args, **error))
    assert cuda_lib.ptr(None) == 0 and cuda_lib.ptr(t) == t.data_ptr()

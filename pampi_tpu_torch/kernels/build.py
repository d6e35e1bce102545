"""Build the port's CUDA kernels and bind them to Python.

Every `pampi_tpu_torch/csrc/<name>.cu` is compiled at first use, by `nvcc`
for Hopper (`sm_90a`), into a shared library with a plain C interface under
`build/torch_kernels/` at the repository root, and loaded with `ctypes`:
pointers and the stream travel as `c_void_p`, and every C entry point
returns the `cudaError_t` of its launches, which `check` turns into an
exception. The library name carries a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is reused. A failed build
raises; nothing falls back to another implementation.

`--fmad=false` keeps the kernels' arithmetic the plain sequence of IEEE
multiplies and adds that the PyTorch plain versions and the JAX package
compute, so a kernel can be held to its plain version at round-off level.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclass
class Kernel:
    """One hand-written kernel of the port: where its source lives, which
    TPU kernel it replaces, and how many times its wrapper launched it
    (CUDA tensors only; the plain version on CPU tensors never counts)."""

    name: str
    source: str
    replaces: str
    launches: int = 0


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    KERNELS[name] = Kernel(name, source, replaces)
    return KERNELS[name]


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def sources() -> list[str]:
    """Names of the kernel sources in the checkout."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None, verbose: bool = False) -> dict[str, float]:
    """Compile the named sources (default: all), one `nvcc` per source, all
    started together. Returns {name: seconds} (0.0 for a library already
    built); raises RuntimeError with the compiler's output if any build
    fails. `verbose` adds `-Xptxas -v` and prints the compiler's report
    (registers, shared memory, spills)."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}.cu]\n{log}")
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The bound library `name`, built first if needed. `signatures` maps
    each C entry point to its argtypes; every entry point returns int."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

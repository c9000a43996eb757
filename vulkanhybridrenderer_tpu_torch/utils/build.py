"""Build native code into shared libraries, keyed on the sources' content.

CUDA kernels (``csrc/*.cu``) are compiled with nvcc into libraries with a plain
C interface and loaded with ctypes; the host BVH builder (``native/*.cpp`` of
the repository) is compiled with g++ the same way.  Outputs go to the
package's ``_build/`` directory (ignored by git) under a name that hashes the
command line and every source byte, and nothing else: not the working
directory, nor the module or line that asks.  So whoever asks gets one build,
an edited source or a changed flag gets a new one, and an unchanged one loads
at once.  A failed build raises with the compiler's output; nothing falls
back.

``toy_scale`` is the smallest kernel built this way (csrc/toy_scale.cu,
o = x * 2), the counterpart of the reference's cache-key test kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = PACKAGE_DIR.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no a*b+c -> fma contraction: the kernels must round like the plain
    # PyTorch versions and the reference (edge pixels flip otherwise)
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# native/Makefile's flags: with -march=native g++ contracts the SAH cost
# arithmetic into FMAs, and the tree must be the one the reference builds
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch was built against."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(name: str, compiler: list[str], sources: list[Path],
                  headers: list[Path] = ()) -> Path:
    """Compile `sources` with `compiler` (a command line without -o) into
    ``BUILD_DIR/<name>-<digest>.so``; return its path.  The digest covers
    the command line and each source's and header's name and bytes.  The
    compiler's stderr (nvcc's -Xptxas=-v register report) is kept beside it
    as ``.log``; ``build_library.compiles`` counts the compiler runs."""
    h = hashlib.sha256(" ".join(compiler).encode())
    for src in [*sources, *headers]:
        src = Path(src)
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent test workers may
    # build the same library at once
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    build_library.compiles += 1
    proc = subprocess.run(
        compiler + ["-o", str(tmp)] + [str(Path(s).resolve()) for s in sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed ({' '.join(compiler)}):\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


build_library.compiles = 0


def cuda_library_path(source: str) -> Path:
    """Build ``csrc/<source>`` with nvcc (sm_90a) if needed; its path.  The
    headers of ``csrc/`` are part of its key."""
    return build_library(Path(source).stem, [nvcc_path()] + NVCC_FLAGS, [CSRC_DIR / source],
                         headers=sorted(CSRC_DIR.glob("*.cuh")))


def load_cuda_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` with nvcc (sm_90a) and load it."""
    return ctypes.CDLL(str(cuda_library_path(source)))


def build_log(source: str) -> str:
    """The compiler report of the current build of ``csrc/<source>``."""
    stem = Path(source).stem
    logs = sorted(BUILD_DIR.glob(f"{stem}-*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""


def current_stream(index: int) -> int:
    """The raw handle of CUDA device `index`'s current PyTorch stream, read
    without building a torch.cuda.Stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


@functools.cache
def load_toy_kernel():
    fn = load_cuda_library("toy_scale.cu").toy_scale_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def toy_scale(x):
    """o = x * 2 (float32): csrc/toy_scale.cu on a CUDA tensor, its plain
    version on a CPU tensor; both take what the kernel takes, and anything
    else raises.  The launch path is kept short: the checks, one output, one
    read of the stream, and the device switch inside the launch function
    (csrc/device_guard.cuh), a no-op when x's card is current."""
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or not (x.is_cuda or x.device.type == "cpu")):
        raise ValueError(f"toy_scale: a contiguous float32 CPU or CUDA tensor, got "
                         f"{'a contiguous' if x.is_contiguous() else 'a non-contiguous'} "
                         f"{x.dtype} tensor on {x.device}")
    if not x.is_cuda:
        return x * 2.0
    out = torch.empty_like(x)
    index = x.get_device()
    err = load_toy_kernel()(x.data_ptr(), out.data_ptr(), x.numel(), index,
                            current_stream(index))
    if err != 0:
        raise RuntimeError(f"toy_scale kernel launch failed: CUDA error {err}")
    toy_scale.launches += 1
    return out


toy_scale.launches = 0

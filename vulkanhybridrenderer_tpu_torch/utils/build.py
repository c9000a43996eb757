"""Build native code into shared libraries, keyed on the sources' content.

CUDA kernels (``csrc/*.cu``) are compiled with nvcc into libraries with a plain
C interface and loaded with ctypes; the host BVH builder (``native/*.cpp`` of
the repository) is compiled with g++ the same way.  Outputs go to the
package's ``_build/`` directory (ignored by git) under a name that hashes the
command line and every source byte, so an edited source rebuilds and an
unchanged one loads at once.  A failed build raises with the compiler's
output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


def build_library(name: str, compiler: list[str], sources: list[Path]) -> Path:
    """Compile `sources` with `compiler` (a command line without -o) into
    ``_build/<name>-<digest>.so``; return its path.  The compiler's stderr
    (nvcc's -Xptxas=-v register report) is kept beside it as ``.log``."""
    h = hashlib.sha256(" ".join(compiler).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    # build under a private name, then rename: concurrent test workers may
    # build the same library at once
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        compiler + ["-o", str(tmp)] + [str(s) for s in sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed ({' '.join(compiler)}):\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def load_cuda_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` with nvcc (sm_90a) and load it."""
    src = CSRC_DIR / source
    path = build_library(Path(source).stem, [nvcc_path()] + NVCC_FLAGS, [src])
    return ctypes.CDLL(str(path))


def build_log(source: str) -> str:
    """The compiler report of the current build of ``csrc/<source>``."""
    stem = Path(source).stem
    logs = sorted(BUILD_DIR.glob(f"{stem}-*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""

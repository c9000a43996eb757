"""ctypes loader for the host BVH builders in ``native/`` (lbvh.cpp, sah.cpp,
bvh8.cpp): the LBVH, the binned-SAH tree and the 8-wide collapse.

The port compiles the repository's ``native/*.cpp`` with g++ into its own
ignored build directory (utils/build.py) and never rebuilds the reference's
tracked ``native/libvhr_native.so``.  Argument types follow the reference
bridge (``vulkanhybridrenderer_tpu/native_bridge.py``).  ``load`` raises
where g++ is missing or the build fails; ``native_available`` says so
without raising, and callers that can do without the library (the
renderer's BVH, ``ops/bvh8.build_bvh8_host``) take the device LBVH and the
Python collapse instead, as the reference does.
"""
from __future__ import annotations

import ctypes
import functools
import shutil

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.ops.bvh import BVH
from vulkanhybridrenderer_tpu_torch.utils import build
from vulkanhybridrenderer_tpu_torch.utils.build import GXX_FLAGS, REPO_DIR

NATIVE_DIR = REPO_DIR / "native"


@functools.cache
def load() -> ctypes.CDLL:
    srcs = sorted(NATIVE_DIR.glob("*.cpp"))
    if not srcs:
        raise RuntimeError(f"no native sources under {NATIVE_DIR}")
    lib = ctypes.CDLL(str(build.build_library("vhr_native", ["g++"] + GXX_FLAGS, srcs)))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for fn in (lib.lbvh_build, lib.sah_build):
        fn.restype = ctypes.c_int
        fn.argtypes = [f32p, ctypes.c_int] + [i32p] * 5 + [f32p] * 2
    lib.bvh8_collapse.restype = ctypes.c_int
    lib.bvh8_collapse.argtypes = [
        f32p, ctypes.c_int, i32p, i32p, i32p, i32p, f32p, f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i32p, u8p, i32p, ctypes.c_int, i32p,
    ]
    return lib


@functools.cache
def native_available() -> bool:
    """Whether the host builders load: g++ is on PATH and native/ builds and
    loads (the reference's native_available).  False where any of that
    fails, without raising; the answer is kept for the process."""
    if shutil.which("g++") is None:
        return False
    try:
        load()
    except (OSError, RuntimeError):  # no compiler, a failed build, a bad .so
        return False
    return True


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _binary_build(fn, tri_verts: np.ndarray):
    """Run a native binary builder (lbvh_build or sah_build) over (T, 3, 3)
    triangles; its seven arrays as numpy."""
    tris = np.ascontiguousarray(np.asarray(tri_verts, np.float32)).reshape(-1, 9)
    n = tris.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    total = 2 * n - 1
    out = dict(
        left=np.empty(total, np.int32),
        right=np.empty(total, np.int32),
        escape=np.empty(total, np.int32),
        leaf_tri=np.empty(total, np.int32),
        order=np.empty(n, np.int32),
        aabb_min=np.empty((total, 3), np.float32),
        aabb_max=np.empty((total, 3), np.float32),
    )
    rc = fn(
        _f32p(tris), n, _i32p(out["left"]), _i32p(out["right"]),
        _i32p(out["escape"]), _i32p(out["leaf_tri"]), _i32p(out["order"]),
        _f32p(out["aabb_min"]), _f32p(out["aabb_max"]),
    )
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed with code {rc}")
    return out


def _bvh(arrays: dict) -> BVH:
    return BVH(**{k: torch.from_numpy(v) for k, v in arrays.items()}, leaf_size=1)


def build_bvh_host(tri_verts: np.ndarray) -> BVH:
    """The LBVH of (T, 3, 3) triangles on the host (native/lbvh.cpp), equal
    to ops/bvh.build's tree (same algorithm, same tie-breaks), on the CPU,
    without octant links (ops/bvh.with_octant_links adds them)."""
    out = _binary_build(load().lbvh_build, tri_verts)
    # the builder gives a leaf its triangle id; BVH.leaf_tri is the leaf's
    # start index into `order`, its sorted position (leaf_size 1)
    num_internal = out["order"].shape[0] - 1
    node = np.arange(out["leaf_tri"].shape[0], dtype=np.int32)
    out["leaf_tri"] = np.where(out["leaf_tri"] >= 0, node - num_internal, -1).astype(np.int32)
    return _bvh(out)


def build_sah_host(tri_verts: np.ndarray) -> BVH:
    """Binned-SAH binary BVH over (T, 3, 3) triangles (native/sah.cpp), on
    the CPU, without octant links.  The root is node 0; leaves index
    `order`."""
    return _bvh(_binary_build(load().sah_build, tri_verts))


def bvh8_collapse_host(bvh: BVH, tri_verts: np.ndarray, leaf_max: int = 8):
    """Collapse any binary BVH (its own leaf_size and root) into BVH8 rows
    (native/bvh8.cpp).  Returns ((N, 128) f32 rows, depth)."""
    lib = load()
    tris = np.ascontiguousarray(np.asarray(tri_verts, np.float32)).reshape(-1, 9)
    t = tris.shape[0]
    arrays = {
        k: np.ascontiguousarray(getattr(bvh, k).cpu().numpy())
        for k in ("left", "right", "leaf_tri", "order", "aabb_min", "aabb_max")
    }
    cap = 2 * max(t, 8) + 16
    rows = np.zeros((cap, 128), np.float32)
    child8 = np.zeros((cap, 8), np.int32)
    valid8 = np.zeros((cap, 8), np.uint8)
    tri8 = np.zeros((cap, leaf_max), np.int32)
    out = np.zeros(2, np.int32)
    rc = lib.bvh8_collapse(
        _f32p(tris), t, _i32p(arrays["left"]), _i32p(arrays["right"]),
        _i32p(arrays["leaf_tri"]), _i32p(arrays["order"]),
        _f32p(arrays["aabb_min"]), _f32p(arrays["aabb_max"]),
        arrays["left"].shape[0], bvh.leaf_size, bvh.root, leaf_max, _f32p(rows),
        _i32p(child8), valid8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _i32p(tri8),
        cap, _i32p(out),
    )
    if rc != 0:
        raise RuntimeError(f"bvh8_collapse failed with code {rc}")
    n_rows, depth = int(out[0]), int(out[1])
    return rows[:n_rows].copy(), depth

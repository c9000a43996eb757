"""K2's CUDA source itself, built by g++ against a warp emulation and run on
the CPU, against trace_plain.

csrc/bvh8_trace.cu has no interpret mode and this machine no nvcc, so the
test compiles the source as C++20 with tests/cuda_warp_emu.h standing in
for the CUDA runtime (each warp's 32 lanes are 32 threads meeting at every
shuffle, vote and __syncwarp) and -ffp-contract=off for nvcc's
--fmad=false, and calls bvh8_trace_launch with host pointers.  Every row
kind (f32 leaf-8 in place; f32 leaf-12 and bf16 through pack_rows' copy),
any-hit and closest-hit, with and without the alpha filter, on the small
SponzaProxy's tables and rays (half aimed at alpha-masked triangles, a
tenth axis-parallel, some with tmax < tmin): t, tri, u and v equal to
trace_plain's on every ray.  Skips without g++.  ~20 s alone.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu_torch.ops import bvh as pbvh
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import shadetab, traverse
from vulkanhybridrenderer_tpu_torch.ops.geometry import to_world
from vulkanhybridrenderer_tpu_torch.scene import procedural
from vulkanhybridrenderer_tpu_torch.utils.build import CSRC_DIR

torch.set_num_threads(2)
N_RAYS = 384


def _emulated_source(name: str) -> str:
    src = (CSRC_DIR / name).read_text()
    src, n = re.subn(r"#include <cuda_runtime\.h>", '#include "cuda_warp_emu.h"', src)
    assert n == 1
    if name == "bvh8_trace.cu":
        src, n = re.subn(r"extern __shared__ int2 stacks\[\];",
                         "int2* stacks = emu_shared<int2>();", src)
        assert n == 2  # both kernels
        src, n = re.subn(r"([A-Za-z0-9_]+(?:<[^>]*>)?)<<<([^>]*)>>>\(", r"emu_launch(\2, &\1, ",
                         src)
        assert n == 3  # the three kinds' launches
    return src


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    d = tmp_path_factory.mktemp("k2emu")
    for name in ("bvh8_trace.cu", "alpha_filter.cuh"):
        (d / name).write_text(_emulated_source(name))
    shutil.copy(Path(__file__).parent / "cuda_warp_emu.h", d)
    lib = d / "libk2emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-w", "-I", str(d), "-x", "c++", str(d / "bvh8_trace.cu"),
                    "-o", str(lib)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).bvh8_trace_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    return fn


@pytest.fixture(scope="module")
def scene():
    s = procedural.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    buf = s.buffers.to("cpu")
    tris = pbvh.world_triangles(to_world(buf, buf.prim_transform).position, buf.tri_vertex)
    b8 = pbvh8.build_bvh8_sah_host(tris.numpy())
    tables = {"f32-8": b8, "f32-12": pbvh8.build_bvh8_sah_host(tris.numpy(), leaf_max=12),
              "bf16-8": pbvh8.table_to_bf16(b8)}
    rng = np.random.default_rng(11)
    t = tris.numpy()
    masked = buf.alpha_tri_idx.numpy()
    assert masked.size
    target = np.where((np.arange(N_RAYS) % 2 == 0)[:, None],
                      t[rng.choice(masked, N_RAYS)].mean(axis=1),
                      t[rng.integers(0, t.shape[0], N_RAYS)].mean(axis=1))
    lo, hi = t.reshape(-1, 3).min(0), t.reshape(-1, 3).max(0)
    o = (lo + (hi - lo) * rng.random((N_RAYS, 3))).astype(np.float32)
    d = (target - o).astype(np.float32)
    d[::10, rng.integers(0, 3)] = 0.0
    tmax = np.where(rng.random(N_RAYS) < 0.05, -1.0, 2.0 * np.linalg.norm(d, axis=1))
    return tables, shadetab.build_shade_tables(buf), *(
        torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (o, d, tmax))


@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("anyhit", [False, True], ids=["closest-hit", "any-hit"])
@pytest.mark.parametrize("kind", ["f32-8", "f32-12", "bf16-8"])
def test_emulated_k2_equals_plain(k2, scene, kind, anyhit, filtered):
    tables, shade, o, d, tmax = scene
    b = tables[kind]
    assert b.kind == kind
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3)
    table = traverse.kernel_table(b).contiguous()
    alpha = shade if filtered else None
    ts, aq, rows, aw = traverse._table_args(alpha)
    out = [torch.empty(n, dtype=t) for t in (torch.float32, torch.int32, torch.float32,
                                             torch.float32)]
    err = k2(table.data_ptr(), o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
             traverse.default_max_steps(b), int(anyhit), b.depth, traverse.KERNEL_KINDS[kind],
             ts, aq, rows, aw, *[x.data_ptr() for x in out], None)
    assert err == 0
    filt = None if alpha is None else traverse.make_alpha_hit_filter(None, alpha)
    want = traverse.trace_plain(b.rows, b.depth, o, d, tmin, tmax, anyhit,
                                traverse.default_max_steps(b), filt, leaf_max=b.leaf_max)
    for got, f in zip(out, ("t", "tri", "u", "v")):
        assert torch.equal(got, getattr(want, f)), f
    assert 0.3 < float(want.hit.float().mean()) < 1.0

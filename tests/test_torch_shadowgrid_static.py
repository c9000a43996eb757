"""The port's static shadow-grid build (ops/shadowgrid.build_shadow_grid)
against the reference's ``_build_shadow_grid``, array for array.

Both size every table from the triangle count alone: T * span_cap dense
slots, med1_cap * 64 and med2_cap * 256 medium-list slots, a row for each,
the padding sorted last (triangle 0's vertices, id -1), BIG_CAP big rows,
and num_big and overflow as () int32 arrays.  Exact, against the reference
run op by op (``jax.disable_jit()``: jit contracts the dilation's
multiply-add into an FMA).  Cases: pica_proxy() over two animate_pica
steps at the load-time resolution (the in-frame rebuild's inputs), and a
synthetic scene whose medium-1, medium-2 and big tiers all overflow their
caps.  tests/test_torch_shadowgrid.py::test_build_matches holds the same
arrays, padding rows included, on that file's two scenes (cornell_box()
and a SponzaProxy), so they are not built twice.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import shadowgrid as jsg
from vulkanhybridrenderer_tpu.ops.geometry import to_world
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch.ops import shadowgrid as psg

torch.set_num_threads(2)
FIELDS = ("entries", "offsets", "u_axis", "v_axis", "origin_uv", "inv_cell", "big", "num_big",
          "overflow")


def _tris(sc, prim_transform=None):
    world = to_world(sc.buffers, sc.buffers.prim_transform if prim_transform is None
                     else jnp.asarray(prim_transform))
    return np.array(jbvh.world_triangles(world.position, sc.buffers.tri_vertex))


def _overflowing(seed=7):
    """Triangles in the y = 0..1 slab, the light straight down, so (u, v) =
    (-z, x) and a 32-cell grid over [0, 32]^2 makes a cell one unit: 4,200
    triangles of 5 x 5 units (about 36 cells: medium 1, cap 4,096), 1,100 of
    10 x 10 (about 121 cells: medium 2, cap 1,024), 150 of 20 x 20 (big,
    cap 128), 200 small ones, and the window's corners."""
    rng = np.random.default_rng(seed)

    def quads(n, size):
        x0 = rng.uniform(0, 32 - size, n)
        z0 = rng.uniform(-32, -size, n)
        y = rng.uniform(0, 1, n)
        v0 = np.stack([x0, y, z0], -1)
        return np.stack([v0, v0 + [size, 0, 0], v0 + [0, 0, size]], 1)

    corners = np.array([[[0, 0, 0], [0.1, 0, 0], [0, 0, -0.1]],
                        [[32, 1, -32], [31.9, 1, -32], [32, 1, -31.9]]])
    tris = np.concatenate([quads(4200, 5.0), quads(1100, 10.0), quads(150, 20.0),
                           quads(200, 0.3), corners])
    return tris[rng.permutation(tris.shape[0])].astype(np.float32)


def _case(name):
    """(triangles, light direction, grid) of a case."""
    if name.startswith("pica"):
        sc = jproc.pica_proxy()
        step = int(name[-1])
        light = np.array(sc.light.direction[:3])
        grid = psg.grid_resolution(_tris(sc), light)
        return _tris(sc, jproc.animate_pica(sc, step / 4.0)), light, grid
    return _overflowing(), np.array([0.0, -1.0, 0.0], np.float32), 32


@pytest.mark.parametrize("name", ["pica step 1", "pica step 2", "overflowing tiers"])
def test_static_build_equals_reference(name):
    tris, light, grid = _case(name)
    with jax.disable_jit():
        j = jsg.build_shadow_grid(jnp.asarray(tris), jnp.asarray(light), grid=grid)
    p = psg.build_shadow_grid(torch.from_numpy(tris), torch.from_numpy(light), grid=grid)
    assert (p.grid, p.span_cap) == (j.grid, j.span_cap)
    for f in FIELDS:
        got, want = getattr(p, f), np.asarray(getattr(j, f))
        assert tuple(got.shape) == want.shape, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    t = tris.shape[0]
    rows = t * 16 + max(4096, t // 8) * psg.MED1_SPAN + max(1024, t // 16) * psg.MED2_SPAN
    assert p.num_entries == rows and p.num_big.shape == p.overflow.shape == ()
    live = int(p.offsets[-1])
    assert 0 < live < rows
    # padding: after the live rows, triangle 0's vertices and id -1
    pad = p.entries[live:]
    assert bool((pad[:, 9] == -1).all()) and bool((p.entries[:live, 9] >= 0).all())
    assert torch.equal(pad[:, :9], torch.from_numpy(tris[0].reshape(9)).expand(rows - live, 9))
    nb = int(p.num_big)
    assert bool((p.big[nb:, 9] == -1).all()) and bool((p.big[:nb, 9] >= 0).all())
    if name == "overflowing tiers":
        # every tier past its cap: 104 + 76 + 22 triangles dropped
        assert nb == psg.BIG_CAP
        assert int(p.overflow) == (4200 - 4096) + (1100 - 1024) + (150 - 128)
    else:
        assert int(p.overflow) == 0


def test_pica_steps_move_the_grid():
    """The two animated steps bin different cells at one resolution, with
    tables of one size: what lets a CUDA graph replay the rebuild."""
    a_tris, light, grid = _case("pica step 1")
    b_tris, _, _ = _case("pica step 2")
    a = psg.build_shadow_grid(torch.from_numpy(a_tris), torch.from_numpy(light), grid=grid)
    b = psg.build_shadow_grid(torch.from_numpy(b_tris), torch.from_numpy(light), grid=grid)
    assert a.entries.shape == b.entries.shape and a.offsets.shape == b.offsets.shape
    assert not torch.equal(a.offsets, b.offsets)

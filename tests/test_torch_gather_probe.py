"""The row-gather probe's plain versions (probes/gather.py; rows 3-6 of the
TPU kernel table) against the JAX probes' walks, on the same numpy table.

The JAX side runs what scripts/bench_pallas_gather.py and
scripts/probe_dyngather.py compute, per walker, in plain jnp:
``xla_walk``'s dependent row gather, the per-lane ``take_along_axis`` walk,
``pallas_dyn_slice_loop``'s repeated row load (row-loop) and the S-row
accumulating walk (test_torch_gather_tpu_kernels.py runs the Pallas kernels
themselves in interpret mode).  Small sizes: N =
512 rows, W = 256 walkers, 64 steps.  Final row ids must be equal; each
walker's sum within 1e-5 relative (measured: bit-equal, both add in step
order).  The script's own ``xla_walk`` (its 512 steps, every walker's sum
reduced to one number) is held to 1e-4 relative (measured 4.9e-9).  The
kernels themselves are held bit for bit against these plain versions by
chip_smoke.py on the card.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu_torch.probes import gather

N, W, STEPS = 512, 256, 64


@pytest.fixture(scope="module")
def table():
    return gather.make_table(N, seed=3), gather.start_rows(N, W, seed=3)


def _jax_walk(tab, idx0, steps):
    def body(s, c):
        idx, acc = c
        rows = tab[idx]
        return rows[:, 48].astype(jnp.int32), acc + rows[:, 0]

    return jax.lax.fori_loop(0, steps, body, (idx0, jnp.zeros(idx0.shape, jnp.float32)))


def _jax_lane(tab, idx0, steps):
    n = tab.shape[0]

    def body(s, c):
        idx, acc = c  # (W // 128, 128): walker i reads column i % 128
        v = jnp.take_along_axis(tab, idx, axis=0)
        return (idx + v.astype(jnp.int32) * 7 + s) % n, acc + v

    idx, acc = jax.lax.fori_loop(
        0, steps, body, (idx0.reshape(-1, 128), jnp.zeros((idx0.shape[0] // 128, 128),
                                                          jnp.float32)))
    return idx.reshape(-1), acc.reshape(-1)


def _jax_row_loop(tab, idx0, steps):
    """pallas_dyn_slice_loop per walker: row idx0[i] loaded again each step
    (nothing writes the ids) and its row[0] added."""
    def body(s, acc):
        return acc + tab[idx0][:, 0]

    return idx0, jax.lax.fori_loop(0, steps, body, jnp.zeros(idx0.shape, jnp.float32))


def _jax_rows_acc(tab, idx0, steps):
    """scripts/probe_dyngather.py's rule: row idx mod N each step, the final
    ids unreduced."""
    def body(s, c):
        idx, acc = c
        rows = tab[jnp.mod(idx, tab.shape[0])]
        return rows[:, 48].astype(jnp.int32), acc + rows

    return jax.lax.fori_loop(0, steps, body,
                             (idx0, jnp.zeros((idx0.shape[0], 128), jnp.float32)))


@pytest.mark.parametrize("kind", ["thread-row", "warp-row", "chase", "lane", "rows-acc",
                                  "row-loop"])
def test_walk_matches_jax(table, kind):
    tab, idx0 = table
    ref = {"lane": _jax_lane, "rows-acc": _jax_rows_acc,
           "row-loop": _jax_row_loop}.get(kind, _jax_walk)
    j_idx, j_acc = (np.asarray(a) for a in jax.jit(ref, static_argnums=2)(
        jnp.asarray(tab), jnp.asarray(idx0), STEPS))
    before = dict(gather.launches)
    p_idx, p_acc = gather.walk(kind, torch.from_numpy(tab), torch.from_numpy(idx0), STEPS)
    assert dict(gather.launches) == before  # the plain version on the CPU
    np.testing.assert_array_equal(p_idx.numpy(), j_idx)
    np.testing.assert_allclose(p_acc.numpy(), j_acc, rtol=1e-5, atol=1e-5)
    assert len(np.unique(j_idx)) > 1


def test_lane_matches_jax_on_the_large_value_table(table):
    """lane_table's values reach +-1e5 (the kernel's `%` path) and +-3.1e8,
    whose product with 7 wraps in int32: the floor modulo and the wrap are
    jnp's; ids equal, sums within 1e-5 relative."""
    _, idx0 = table
    tab = gather.lane_table(N, seed=3)
    j_idx, j_acc = (np.asarray(a) for a in jax.jit(_jax_lane, static_argnums=2)(
        jnp.asarray(tab), jnp.asarray(idx0), STEPS))
    p_idx, p_acc = gather.walk("lane", torch.from_numpy(tab), torch.from_numpy(idx0), STEPS)
    np.testing.assert_array_equal(p_idx.numpy(), j_idx)
    np.testing.assert_allclose(p_acc.numpy(), j_acc, rtol=1e-5, atol=1e-5)
    slow = gather.lane_slow_steps(torch.from_numpy(tab), torch.from_numpy(idx0), STEPS)
    assert 0 < slow < W * STEPS


def test_lane_slow_steps_equals_a_replay(table):
    _, idx0 = table
    tab = gather.lane_table(N, seed=3)
    want = 0
    for i, r in enumerate(idx0.tolist()):
        for s in range(STEPS):
            d = int(np.float32(tab[r, i % 128]).astype(np.int64)) * 7 + s
            d = (d + 2**31) % 2**32 - 2**31  # int32, as the walk's
            want += abs(d) >= N
            r = ((r + d + 2**31) % 2**32 - 2**31) % N
    got = gather.lane_slow_steps(torch.from_numpy(tab), torch.from_numpy(idx0), STEPS)
    assert got == want


def test_walk_matches_the_scripts_xla_walk(table):
    """scripts/bench_pallas_gather.py's own xla_walk (at its STEPS) against
    the plain walk: acc + sum(final ids)."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "bench_pallas_gather.py"
    spec = importlib.util.spec_from_file_location("bench_pallas_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tab, idx0 = table
    ref = float(mod.xla_walk(jnp.asarray(tab), jnp.asarray(idx0)))
    p_idx, p_acc = gather.walk_plain(torch.from_numpy(tab), torch.from_numpy(idx0), mod.STEPS)
    got = float(p_acc.double().sum() + p_idx.double().sum())
    assert got == pytest.approx(ref, rel=1e-4)


def test_gather16_plain():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((12, 20, 4), dtype=np.float32)
    idx = rng.integers(0, 240, 500).astype(np.int32)
    got = gather.gather16(torch.from_numpy(img), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, img.reshape(-1, 4)[idx])


@pytest.mark.parametrize("kind", ["thread-row", "warp-row", "chase", "lane", "rows-acc",
                                  "row-loop"])
def test_table_bytes_read(table, kind):
    """The probe's byte bound counts the table bytes the walk reads on this
    data: a Python replay of the walk collects the (row, column) values each
    step reads; exact."""
    tab, idx0 = table
    read = set()
    for i, r in enumerate(idx0.tolist()):
        for s in range(STEPS):
            if kind == "row-loop":  # the same row[0] every step
                read.add((r, 0))
            elif kind == "lane":
                v = tab[r, i % 128]
                read.add((r, i % 128))
                r = (r + int(v) * 7 + s) % N
            else:
                cols = (0, 48) if kind == "chase" else range(128)
                read.update((r, c) for c in cols)
                r = int(tab[r, 48])
    got = gather.table_bytes_read(kind, torch.from_numpy(tab), torch.from_numpy(idx0), STEPS)
    assert got == len(read) * 4
    assert got < tab.nbytes

"""The row-gather probe's plain versions (probes/gather.py) against the TPU
kernels of scripts/bench_pallas_gather.py themselves, run in Pallas's TPU
interpret mode on the CPU (``pltpu.force_tpu_interpret_mode``).

The script is loaded with importlib and left as it is; only its module-level
sizes are set: N = 256 rows, W = 1024 walkers (``pallas_take_along_axis``
needs W // 8 == 128 lanes) and STEPS = 4.  Each kernel reduces its walk to
one float32 scalar, and the port's plain walk is reduced the same way:
  B  pallas_vector_gather (row 3): the sum of every walker's row[0] over
     every step plus the sum of the final ids; walk_plain, thread-row's and
     warp-row's plain version;
  C  pallas_take_along_axis (row 5): row[0] of the gathered (8, 128) block
     each step (the walkers i with i % 128 == 0) plus the sum of all final
     ids; lane_plain;
  D  pallas_dyn_slice_loop (row 4): STEPS x the sum of row[0] over the
     walkers' start rows (it reads ids nothing writes); row_loop_plain.
The ids are exact: the port's exact sum of final ids is taken from the
kernel's scalar, and what remains is held against the port's reduced sums of
row[0].  The kernels add in another order than the port (D one float32 chain
of W x STEPS adds), so the tolerance is 1e-4 of the sum of the row[0] terms'
magnitudes (the same walk with |row[0]|) plus one float32 ulp of the scalar
(the kernel's last add, of the ids' sum, rounds to it).
Row 6 (scripts/probe_dyngather.py:63) cannot run this way: its
``bvh_dyn_gather`` primitive has no CPU lowering, so
test_torch_gather_probe.py holds it against a jnp replay.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vulkanhybridrenderer_tpu_torch.probes import gather

N, W, STEPS = 256, 1024, 4


@pytest.fixture(scope="module")
def script():
    path = Path(__file__).resolve().parents[1] / "scripts" / "bench_pallas_gather.py"
    spec = importlib.util.spec_from_file_location("bench_pallas_gather_interpret", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N, mod.W, mod.STEPS = N, W, STEPS
    return mod


@pytest.fixture(scope="module")
def table():
    return gather.make_table(N, seed=7), gather.start_rows(N, W, seed=7)


def _reduced(kind, tab, idx0):
    """The port's plain walk reduced as the TPU kernel reduces its own:
    (exact sum of the final ids, sum of the row[0] terms, sum of their
    magnitudes)."""
    t, i = torch.from_numpy(tab), torch.from_numpy(idx0)
    t_abs = t.clone()
    t_abs[:, 0] = t_abs[:, 0].abs()  # the same walk: column 48 is kept
    if kind == "pallas_vector_gather":
        ids, acc = gather.walk("thread-row", t, i, STEPS)
        _, mag = gather.walk("thread-row", t_abs, i, STEPS)
        return float(ids.double().sum()), float(acc.double().sum()), float(mag.double().sum())
    if kind == "pallas_take_along_axis":
        ids, acc = gather.walk("lane", t, i, STEPS)
        ids_sum = float(ids.double().sum())
        # |row[0]| of the same visits: the walk's path depends on row[0]'s sign
        # through int(v), so the magnitudes are gathered along this walk
        cols = torch.arange(W) % 128
        idx, mag = i.long(), 0.0
        for s in range(STEPS):
            v = t[idx, cols]
            mag += float(v[::128].double().abs().sum())
            idx = torch.remainder(idx + v.to(torch.int32) * 7 + s, N).long()
        return ids_sum, float(acc[::128].double().sum()), mag
    ids, acc = gather.walk("row-loop", t, i, STEPS)
    _, mag = gather.walk("row-loop", t_abs, i, STEPS)
    np.testing.assert_array_equal(ids.numpy(), idx0)
    return 0.0, float(acc.double().sum()), float(mag.double().sum())


@pytest.mark.parametrize("kind", ["pallas_vector_gather", "pallas_take_along_axis",
                                  "pallas_dyn_slice_loop"])
def test_plain_walk_matches_the_tpu_kernel(script, table, kind):
    tab, idx0 = table
    with pltpu.force_tpu_interpret_mode():
        got = float(np.asarray(getattr(script, kind)()(jnp.asarray(tab),
                                                       jnp.asarray(idx0))).reshape(-1)[0])
    ids_sum, want, mag = _reduced(kind, tab, idx0)
    assert abs((got - ids_sum) - want) <= 1e-4 * mag + float(np.spacing(np.float32(abs(got))))
    assert mag > 0

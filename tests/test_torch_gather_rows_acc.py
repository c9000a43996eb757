"""Row 6 of the probe (probes/gather.py rows-acc) on the CPU: the TPU op's
``mod N`` row rule, each walker's distinct rows and the latency floor.

scripts/probe_dyngather.py's op reads ``src[idx mod N]`` and carries
``rows[:, 48].astype(int32)`` as the next id, unreduced.  ``rows_acc_plain``
is held against a jnp replay of that rule on ``wrap_table``'s 256-row table,
whose column 48 holds 16 ids below 0, 16 at or above N and values with no
int32 (+-inf, NaN, +-3e9, 2^31) or no integer: ids equal, sums equal bit for
bit (both add in step order; NaN where NaN).  ``walker_rows`` gives each
walker's distinct rows on the probe's own data (make_table(N, 0),
start_rows(N, 8, 0), 512 steps), whose counts are pinned here, and
``latency_floor`` prices them: the floor is the lesser of all walkers on
one SM (the rows no other walker reads at L2, the rest at L1) and the
shared-memory route, only where the table fits a block's shared memory;
beside it each walker on an SM of its own (first loads at L2, later loads
at L1 where a walker's rows fit the L1 given, L1_BYTES or the yardstick's
``l1_fit_bytes``); a route's time is its slowest walker's.  The kernel
itself is held against rows_acc_plain bit for bit by chip_smoke.py on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gather_probe import _jax_rows_acc

from vulkanhybridrenderer_tpu_torch.probes import gather

N, STEPS = 256, 64
#: each walker's distinct rows on make_table(N, 0) / start_rows(N, 8, 0), 512 steps
WALKER_ROWS = {
    256: [20, 33, 5, 33, 19, 28, 32, 41],
    2048: [9, 104, 55, 94, 44, 64, 79, 66],
    20480: [420, 118, 121, 138, 271, 63, 224, 257],
}
L1_NS, L2_NS = 19.99, 142.86


@pytest.fixture(scope="module")
def wrapped():
    tab = gather.wrap_table(gather.make_table(N, seed=3), seed=3)
    idx0 = gather.start_rows(N, 64, seed=3)
    idx0[:8] = [-1, -N, -N - 5, -3 * N + 1, N, N + 9, 2 * N, 2**31 - 1]
    return tab, idx0


def test_wrap_table_leaves_the_table():
    tab = gather.make_table(N, seed=3)
    col = gather.wrap_table(tab, seed=3)[:, 48]
    assert (col < 0).sum() >= 17 and (col >= N).sum() >= 18  # 16 each, and -inf, -3e9, ...
    assert np.isnan(col).sum() == 1 and np.isinf(col).sum() == 2
    assert (col != np.trunc(col)).sum() == 2 + 1  # 7.9, -0.5 and NaN


@pytest.mark.parametrize("steps", [1, 5, STEPS])
def test_rows_acc_plain_matches_the_tpu_ops_rule(wrapped, steps):
    tab, idx0 = wrapped
    j_idx, j_acc = (np.asarray(a) for a in jax.jit(_jax_rows_acc, static_argnums=2)(
        jnp.asarray(tab), jnp.asarray(idx0), steps))
    p_idx, p_acc = gather.rows_acc_plain(torch.from_numpy(tab), torch.from_numpy(idx0), steps)
    np.testing.assert_array_equal(p_idx.numpy(), j_idx)
    np.testing.assert_array_equal(p_acc.numpy(), j_acc)


def test_the_wrap_table_exercises_the_rule(wrapped):
    """The walkers read rows whose next id leaves [0, N) or has no int32,
    and such ids come out unreduced as final ids."""
    tab, idx0 = wrapped
    t, i = torch.from_numpy(tab), torch.from_numpy(idx0)
    col = tab[:, 48]
    odd = ~((col >= 0) & (col < N) & (col == np.trunc(col)))
    assert sum(int(odd[rows].sum()) for rows in gather.walker_rows(t, i, STEPS)) >= 8
    finals = np.concatenate([gather.rows_acc_plain(t, i, s)[0].numpy() for s in range(1, 9)])
    assert (finals < 0).any() and (finals >= N).any()
    assert (finals == 2**31 - 1).any() or (finals == -2**31).any()


def test_rows_acc_plain_replay(wrapped):
    """A Python replay of the rule, walker by walker: v = int32(row[48])
    truncated and saturated (NaN 0), the next row v mod N (floor)."""
    tab, idx0 = wrapped
    p_idx, _ = gather.rows_acc_plain(torch.from_numpy(tab), torch.from_numpy(idx0), STEPS)
    for i, v in enumerate(idx0.tolist()):
        for _ in range(STEPS):
            x = float(tab[v % N, 48])
            v = 0 if np.isnan(x) else int(max(-2.0**31, min(2.0**31 - 1, np.trunc(x))))
        assert p_idx[i].item() == v


def test_rows_acc_plain_zero_steps_keeps_the_start_ids(wrapped):
    tab, idx0 = wrapped
    ids, acc = gather.rows_acc_plain(torch.from_numpy(tab), torch.from_numpy(idx0), 0)
    np.testing.assert_array_equal(ids.numpy(), idx0)
    assert not acc.any()


def test_to_int32_is_jnps_astype():
    x = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.0**31, -2.0**31, 2.7, -2.7, -0.5, 255.9],
                 np.float32)
    got = gather.to_int32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(x).astype(jnp.int32)))


@pytest.mark.parametrize("n", sorted(WALKER_ROWS))
def test_walker_rows_on_the_probes_data(n):
    tab = torch.from_numpy(gather.make_table(n, seed=0))
    idx0 = torch.from_numpy(gather.start_rows(n, gather.ROWS_ACC_S, seed=0))
    rows = gather.walker_rows(tab, idx0, gather.STEPS_PROBE)
    assert [len(r) for r in rows] == WALKER_ROWS[n]
    # in the order of their first load: a replay of walker 0
    v, seen = int(idx0[0]), []
    for _ in range(gather.STEPS_PROBE):
        r = v % n
        if r not in seen:
            seen.append(r)
        v = int(tab[r, 48])
    assert rows[0] == seen
    assert (gather.table_bytes_read("rows-acc", tab, idx0, gather.STEPS_PROBE)
            == len(set().union(*rows)) * 512)


#: each walker's rows that no other walker reads, on the same data
ALONE = {
    256: [3, 1, 5, 2, 2, 0, 4, 9],
    2048: [9, 23, 15, 13, 4, 7, 0, 26],
    20480: [199, 1, 4, 46, 44, 63, 22, 30],
}


@pytest.mark.parametrize("n", sorted(WALKER_ROWS))
def test_latency_floor_on_the_probes_data(n):
    """One SM, the floor: the rows no other walker reads at L2, every
    other load at L1.  Own SM beside it: first loads at L2, the rest at L1
    where a walker's rows fit L1_BYTES (420 rows, 215,040 bytes, at N =
    20,480 do), the slowest walker (N = 256: 41 x L2 + 471 x L1)."""
    tab = torch.from_numpy(gather.make_table(n, seed=0))
    idx0 = torch.from_numpy(gather.start_rows(n, gather.ROWS_ACC_S, seed=0))
    walkers = gather.walker_rows(tab, idx0, 512)
    f = gather.latency_floor(walkers, 512, n, L1_NS, L2_NS)
    own = [(k * L2_NS + (512 - k) * L1_NS) * 1e-6 for k in WALKER_ROWS[n]]
    one = [(k * L2_NS + (512 - k) * L1_NS) * 1e-6 for k in ALONE[n]]
    assert f["walker_ms"] == pytest.approx(own, rel=1e-12)
    assert f["own_sm_ms"] == pytest.approx(max(own), rel=1e-12)
    assert f["one_sm_ms"] == pytest.approx(max(one), rel=1e-12)
    assert f["ms"] == f["one_sm_ms"] and f["route"] == "one SM" and f["shared_ms"] is None
    assert f["one_sm_ms"] <= f["own_sm_ms"]
    if n == 256:
        assert f["own_sm_ms"] == pytest.approx((41 * L2_NS + 471 * L1_NS) * 1e-6, rel=1e-12)


def test_latency_floor_routes_on_disjoint_walkers():
    """Walkers that share no row: one SM prices each walker's rows as own
    SM does (while they fit L1); a walker past L1 pays L2 for every load on
    its own SM, L1 for its later loads on the one-SM route's optimism."""
    walkers = [list(range(10)), list(range(10, 40))]
    f = gather.latency_floor(walkers, 100, 1000, L1_NS, L2_NS)
    want = (30 * L2_NS + 70 * L1_NS) * 1e-6
    assert f["own_sm_ms"] == pytest.approx(want, rel=1e-12)
    assert f["one_sm_ms"] == pytest.approx(want, rel=1e-12)
    big = gather.L1_BYTES // 512 + 1
    f = gather.latency_floor([list(range(big))], 2 * big, 40000, L1_NS, L2_NS)
    assert f["own_sm_ms"] == pytest.approx(2 * big * L2_NS * 1e-6, rel=1e-12)
    assert f["one_sm_ms"] == pytest.approx(big * (L2_NS + L1_NS) * 1e-6, rel=1e-12)
    assert f["route"] == "one SM"


def test_latency_floor_own_sm_with_the_measured_l1():
    """Where the yardstick measures 192 KB of L1 for global loads, N =
    20,480's slowest walker (420 rows, 215,040 bytes) no longer fits: each
    of its loads at L2 on its own SM; the walkers that fit keep L1, and the
    floor (one SM) ignores capacity, so it does not move."""
    tab = torch.from_numpy(gather.make_table(20480, seed=0))
    idx0 = torch.from_numpy(gather.start_rows(20480, gather.ROWS_ACC_S, seed=0))
    walkers = gather.walker_rows(tab, idx0, 512)
    f = gather.latency_floor(walkers, 512, 20480, L1_NS, L2_NS, l1_bytes=192 * 1024)
    assert f["walker_ms"][0] == pytest.approx(512 * L2_NS * 1e-6, rel=1e-12)
    assert f["walker_ms"][4] == pytest.approx((271 * L2_NS + 241 * L1_NS) * 1e-6, rel=1e-12)
    assert f["own_sm_ms"] == pytest.approx(512 * L2_NS * 1e-6, rel=1e-12)
    assert f["ms"] == gather.latency_floor(walkers, 512, 20480, L1_NS, L2_NS)["ms"]


@pytest.mark.parametrize("sweep, l1_ns, want", [
    # the L1 ring at 64-256 KB as measured on an H100: L1's latency to 192 KB
    ({64: 19.99, 128: 19.99, 160: 19.99, 192: 19.99, 224: 37.44, 256: 83.76}, 19.99,
     192 * 1024),
    ({64: 20.5, 128: 21.9, 256: 21.9}, 20.0, 256 * 1024),  # within 10% all the way
    ({64: 22.1, 128: 40.0}, 19.99, 32 * 1024),             # none within: the 32 KB ring's
])
def test_l1_fit_bytes(sweep, l1_ns, want):
    assert gather.l1_fit_bytes(sweep, l1_ns) == want


@pytest.mark.parametrize("n, smem_ns, stage_ns, route", [
    (256, 13.0, 1500.0, "shared"),     # fits, and cheaper
    (256, 40.0, 1500.0, "one SM"),     # fits, but dearer than the global routes
    (gather.STAGE_MAX_ROWS, 13.0, 1500.0, "shared"),
    (gather.STAGE_MAX_ROWS + 1, 13.0, 1500.0, "one SM"),  # does not fit
    (2048, 1.0, 0.0, "one SM"),
])
def test_latency_floor_shared_route_only_where_the_table_fits(n, smem_ns, stage_ns, route):
    walkers = [list(range(k)) for k in WALKER_ROWS[256]]
    f = gather.latency_floor(walkers, 512, n, L1_NS, L2_NS, smem_ns, stage_ns)
    fits = n <= gather.STAGE_MAX_ROWS
    assert (f["shared_ms"] is not None) == fits
    if fits:
        assert f["shared_ms"] == pytest.approx((stage_ns + 512 * smem_ns) * 1e-6, rel=1e-12)
    assert f["route"] == route
    assert f["ms"] == min(x for x in (f["one_sm_ms"], f["shared_ms"]) if x is not None)
    assert gather.STAGE_MAX_ROWS == 453  # 227 KB less the barrier's 16 bytes, 512 bytes a row


def test_walk_rows_acc_on_cpu_tensors_launches_nothing(wrapped):
    tab, idx0 = wrapped
    before = dict(gather.launches)
    got = gather.walk("rows-acc", torch.from_numpy(tab), torch.from_numpy(idx0), STEPS)
    assert dict(gather.launches) == before
    ref = gather.rows_acc_plain(torch.from_numpy(tab), torch.from_numpy(idx0), STEPS)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, ref))
    with pytest.raises(ValueError):
        gather.walk("rows-acc", torch.zeros((0, 128)), torch.from_numpy(idx0), STEPS)
    assert dict(gather.launches) == before

"""The probe's wrapper checks and yardstick helpers (probes/gather.py), on
the CPU.

The wrapper's checks (kind, dtype, shape, contiguity, device) raise on CPU
tensors as on CUDA ones, and launch nothing.  The counts that describe the
walk are exact: ``sharing`` (the distinct rows all walkers and each
128-walker block read a step) against a Python replay, ``read_rate_plain``
against a Python replay of the read-rate kernel's partition, ``make_ring``
against stepping its ring, and ``walk_guarded`` (the whole-row kernels'
rules: a stop at an id outside the table, row 0 after a row holding +inf)
against ``walk_plain`` on a finite table and against a Python replay on
``guard_table``'s.  The lane walk refuses a table whose column does not fit
a block's shared memory (``LANE_MAX_ROWS``; the probe's run holds the
launch to the same limit on the card), and row-loop returns its start ids
themselves and refuses ids outside the table, on the CPU.  Sizes: the
gather-probe tests' table, N = 512 rows, W = 256 walkers, 64 steps.
"""
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu_torch.probes import gather

N, W, STEPS = 512, 256, 64


@pytest.fixture(scope="module")
def table():
    return gather.make_table(N, seed=3), gather.start_rows(N, W, seed=3)


def _bad_args(tab, idx0):
    t, i = torch.from_numpy(tab), torch.from_numpy(idx0)
    return {
        "float64 table": (t.double(), i),
        "64 columns": (t[:, :64].contiguous(), i),
        "1-D table": (t.reshape(-1), i),
        "int64 rows": (t, i.long()),
        "2-D rows": (t, i.reshape(2, -1)),
        "non-contiguous table": (t[::2], i),
        "non-contiguous rows": (t, i[::2]),
        "meta device": (t.to("meta"), i.to("meta")),
        "two devices": (t, i.to("meta")),
    }


@pytest.mark.parametrize("kind", sorted(gather.KINDS))
@pytest.mark.parametrize("what", list(_bad_args(np.zeros((4, 128), np.float32),
                                                 np.zeros(4, np.int32))))
def test_walk_checks_raise_on_cpu_tensors(table, kind, what):
    tab, idx0 = table
    bad_tab, bad_idx = _bad_args(tab, idx0)[what]
    before = dict(gather.launches)
    with pytest.raises(ValueError):
        gather.walk(kind, bad_tab, bad_idx, 4)
    assert dict(gather.launches) == before


@pytest.mark.parametrize("what", ["float64 image", "3 channels", "int64 rows", "2-D rows",
                                  "non-contiguous image"])
def test_gather16_checks_raise_on_cpu_tensors(what):
    img = torch.zeros((6, 8, 4))
    idx = torch.zeros(10, dtype=torch.int32)
    bad = {"float64 image": (img.double(), idx), "3 channels": (img[..., :3].contiguous(), idx),
           "int64 rows": (img, idx.long()), "2-D rows": (img, idx.reshape(2, 5)),
           "non-contiguous image": (img[::2], idx)}[what]
    with pytest.raises(ValueError):
        gather.gather16(*bad)


@pytest.mark.parametrize("extra", [0, 1])
def test_lane_refuses_a_column_larger_than_shared_memory(extra):
    tab = torch.zeros((gather.LANE_MAX_ROWS + extra, 128))
    idx0 = torch.arange(4, dtype=torch.int32)
    before = dict(gather.launches)
    if extra:
        with pytest.raises(ValueError, match="shared memory"):
            gather.walk("lane", tab, idx0, 1)
    else:
        got_idx, got_acc = gather.walk("lane", tab, idx0, 1)
        assert got_idx.tolist() == [0, 1, 2, 3] and not got_acc.any()
    assert dict(gather.launches) == before


def test_row_loop_returns_its_start_ids(table):
    """row-loop's ids never change: walk returns idx0 itself (the kernel
    writes the sums alone), and each sum is row[0] added STEPS times."""
    tab, idx0 = table
    t, i = torch.from_numpy(tab), torch.from_numpy(idx0)
    got_idx, got_acc = gather.walk("row-loop", t, i, STEPS)
    assert got_idx is i
    want = np.zeros(W, np.float32)
    for _ in range(STEPS):
        want = want + tab[idx0, 0]
    np.testing.assert_array_equal(got_acc.numpy(), want)


@pytest.mark.parametrize("bad", [-1, N, 2**31 - 1])
def test_row_loop_refuses_ids_outside_the_table(table, bad):
    """walk's contract: ids lie in [0, N); the plain version raises where
    the kernel would keep the id with sum 0."""
    tab, idx0 = table
    ids = idx0.copy()
    ids[7] = bad
    before = dict(gather.launches)
    with pytest.raises(ValueError, match="start ids"):
        gather.walk("row-loop", torch.from_numpy(tab), torch.from_numpy(ids), 4)
    assert dict(gather.launches) == before


def test_unknown_kind_raises(table):
    tab, idx0 = table
    with pytest.raises(ValueError, match="unknown walk kind"):
        gather.walk("row", torch.from_numpy(tab), torch.from_numpy(idx0), 4)


@pytest.mark.parametrize("block", [128, 100, 7])
def test_sharing_counts_equal_a_replay(table, block):
    tab, idx0 = table
    distinct, per_block = gather.sharing(torch.from_numpy(tab), torch.from_numpy(idx0), STEPS,
                                         block)
    rows = idx0.tolist()
    want_distinct, want_block = [], []
    for _ in range(STEPS):
        want_distinct.append(len(set(rows)))
        blocks = [set(rows[b:b + block]) for b in range(0, len(rows), block)]
        want_block.append(sum(len(s) for s in blocks) / len(blocks))
        rows = [int(tab[r, 48]) for r in rows]
    assert distinct == want_distinct
    assert per_block == pytest.approx(want_block, rel=0, abs=1e-12)
    assert distinct[-1] < distinct[0]


@pytest.mark.parametrize("level, blocks, passes", [(1, 3, 5), (1, 7, 2), (2, 3, 5), (2, 1, 3)])
def test_read_rate_plain_equals_a_replay_of_the_kernel(level, blocks, passes):
    """The read-rate kernel's sums (csrc/gather_probe.cu read_rate): level 1,
    block b reads span words from (b % slices) * span; level 2, thread g of
    the grid reads words g, g + T, ... (T = blocks * 512 threads)."""
    tab = np.random.default_rng(5).standard_normal((256, 128), dtype=np.float32)
    words = tab.view(np.uint32).reshape(-1, 4).astype(np.uint64).sum(1)
    span = gather.RATE_SPAN
    want = [0] * blocks
    if level == 1:
        slices = len(words) // span
        for b in range(blocks):
            start = (b % slices) * span
            want[b] = int(words[start:start + span].sum())
    else:
        for x, v in enumerate(words.tolist()):
            want[(x % (blocks * 512)) // 512] += v
    got = gather.read_rate_plain(torch.from_numpy(tab), level, blocks, passes)
    assert got.tolist() == [w * passes % 2**32 for w in want]


@pytest.mark.parametrize("lines", [1, 2, 256])
def test_ring_ends_where_stepping_it_ends(lines):
    ring, order = gather.make_ring(lines)
    assert sorted(ring[::32].tolist()) == [32 * k for k in range(lines)]
    pos = int(order[0]) * 32
    for k in range(1, 3 * lines + 5):
        pos = int(ring[pos])
        assert pos == int(order[k % lines]) * 32


def test_guard_table_cases(table):
    tab, _ = table
    bad = gather.guard_table(tab, seed=3)
    nxt = bad[:, 48]
    assert (nxt < 0).sum() == 16 and (nxt >= N).sum() == 16
    inf_rows = np.isinf(bad).any(1)
    assert inf_rows.sum() == 32 and not (inf_rows & ((nxt < 0) | (nxt >= N))).any()
    changed = (bad != tab).any(1)
    assert changed.sum() == 64
    np.testing.assert_array_equal(bad[~changed], tab[~changed])


def test_walk_guarded_equals_walk_plain_on_a_finite_table(table):
    tab, idx0 = (torch.from_numpy(a) for a in table)
    got = gather.walk_guarded(tab, idx0, STEPS)
    ref = gather.walk_plain(tab, idx0, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_walk_guarded_equals_a_python_replay(table):
    tab, idx0 = table
    bad = gather.guard_table(tab, seed=3)
    got_idx, got_acc = gather.walk_guarded(torch.from_numpy(bad), torch.from_numpy(idx0), STEPS)
    stopped = reset = 0
    for w, start in enumerate(idx0.tolist()):
        idx, acc = start, np.float32(0)
        for _ in range(STEPS):
            if not 0 <= idx < N:
                break
            row = bad[idx]
            acc = np.float32(acc + row[0])
            if np.isposinf(row).any():
                idx, reset = 0, reset + 1
            else:
                idx = int(row[48])
        stopped += not 0 <= idx < N
        assert int(got_idx[w]) == idx
        assert got_acc[w].item() == acc
    assert stopped > 0 and reset > 0

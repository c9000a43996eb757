"""Row-gather probes of the card (port of scripts/bench_pallas_gather.py and
scripts/probe_dyngather.py, rows 3-6 of the TPU kernel table).

    python3 -m vulkanhybridrenderer_tpu_torch.probes.gather [--seed 0]

What a dependent read of an (N, 128) float32 table costs on the card: K2
walks such a table (the BVH8 rows), and the raster-mode frame's SSAO and PCF
taps are independent 16-byte row gathers.  The table and the walk are the
TPU probe's: column 48 of a row holds the next row id, made from --seed with
numpy; a walker starts at a random row, reads its row, adds row[0] to its own
float32 sum and moves to row[48].  Each case checks the kernel against its
plain version bit for bit (final ids and sums) and prints ns per index, GB/s
of gathered bytes, the bound (each distinct value read once at the HBM rate,
or the walk's float32 adds at the FP32 rate, the larger) and its share, and
beside them the L1 ceiling: the gathered bytes at the rate the card's L1
delivers, a rate the yardstick measures, not the bound.
The yardstick (``yardstick``): coalesced 16-byte reads, many passes in one
launch, of a 32 KB slice a block keeps in L1 and of the whole table from L2
(their bits summed and checked against a plain sum), in TB/s and bytes a
clock an SM at the SM clock nvidia-smi reports under that load; one warp's
dependent-load latency through a pointer ring resident in L1 and in L2; and
what the frame-width walkers share (``sharing``): the distinct rows all of
them read at each step, and the mean distinct rows a 128-walker block reads;
the L1 ring's lines from shared memory, rows-acc's step through L1 (the
load, fast_row, the address; and with F2I and the wrap's branch instead of
fast_row), the L1 ring at 64-256 KB, and one block's TMA bulk copy of the
N = 256 table (``stage_copy``).
The cases:
  walk         the plain version: ``tab[idx]`` per step;
  thread-row   (row 3) a thread owns its walker (K4's layout), 32 walkers
               a warp, their rows moved by the warp one coalesced row a load;
  warp-row     (row 3) 16 lanes own a walker (K2's layout is 4 lanes a
               ray), two walkers a warp;
  row-loop     (row 4) pallas_dyn_slice_loop's function: walker i loads
               row[0] of row idx0[i] every step and adds it; its id never
               changes (the TPU kernel reads ids nothing writes).  Printed
               beside a modelled ceiling, W x steps line lookups at one line
               a clock an SM at the yardstick's clock (a model, not a bound);
  lane         (row 5) out[i] = tab[idx_i, i % 128], idx = (idx + v*7 + s) mod N,
               each column staged in a block's shared memory; also with 0
               steps (the transposes in and out and the staging alone) and
               on ``lane_table``, whose values reach +-1e5 so the modulo's
               `%` path runs;
  rows-acc     (row 6) S = 8 warp walkers adding whole rows, N = 256, 2048,
               20480 (128 KB, 1 MB, 10.5 MB tables), the TPU op's rule:
               row v mod N, v = row[48] truncated to int32 (to_int32), the
               final id unreduced.  Each beside its latency floor
               (``latency_floor``: a walker's steps are one chain of
               dependent row loads; the lesser of all walkers on one SM and,
               where the table fits a block's shared memory, one bulk copy
               plus steps shared-memory loads), each walker on an SM of its
               own and the union floor (every step at the level that holds
               the union of the walkers' rows); and on ``wrap_table``, whose
               ids leave the table and whose column 48 holds values with no
               int32, on both of the kernel's routes (N = 256 and 2048);
  chase        a thread per walker reading row[0] and row[48] only, K2's
               walk's latency on the card (no TPU kernel computes it);
  gather16     2,073,600 random 16-byte rows of a 1920x1080x4 image.
Rows 3-5 and the chase run at the TPU probe's W = 1024 walkers x 512 steps
and at the frame's width, W = 2,073,600 x 32 steps, the occupancy K2 runs
at; row 3's walks also on ``guard_table``, whose ids leave the table and
whose rows hold +inf, against ``walk_guarded``, and row-loop and lane from
start ids outside the table (final id that id, sum 0); lane also at N =
LANE_MAX_ROWS, and its launch's refusal one row above.  Every wrapper checks
its arguments on any device (lane also that a column fits a block's shared
memory, N <= LANE_MAX_ROWS; rows-acc a table with a row); on CPU tensors it
runs its plain version, on CUDA tensors its kernel.  ``launches`` counts
wrapper calls that launched (lane's call is four kernels) and the graph
replays of them.  ``run`` needs the card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import subprocess

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.utils.build import current_stream, load_cuda_library

N_ROWS = 20480  # the TPU probe's table: 10.5 MB, SponzaProxy's BVH8 size
W_PROBE, STEPS_PROBE = 1024, 512
W_FRAME, STEPS_FRAME = 1920 * 1080, 32
ROWS_ACC_S, ROWS_ACC_N = 8, (256, 2048, 20480)
#: an SM's L1 and shared memory are one 256 KB array: the union floor takes
#: a union of rows that fits it as L1-resident, and latency_floor's own-SM
#: route a walker's rows unless given the yardstick's measured L1
#: (l1_fit_bytes)
L1_BYTES = 256 * 1024
#: what a staged table may take of a block's shared memory: Hopper's 227 KB
#: less 16 bytes for the staging barrier (csrc's kStageMaxBytes)
STAGE_MAX_BYTES = 232448 - 16
#: rows-acc's staged route: the whole table in a block's shared memory
#: (csrc's kStageMaxRows)
STAGE_MAX_ROWS = STAGE_MAX_BYTES // 512
NEXT = 48  # the column holding the next row id
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
SHARE_BLOCK = 128  # walkers a block, in start order, for sharing()

#: walk kernel -> its kind in csrc/gather_probe.cu's probe_walk_launch
KINDS = {"thread-row": 0, "warp-row": 1, "chase": 2, "lane": 3, "rows-acc": 4, "row-loop": 5}
#: kernel -> the TPU kernel it stands for (the chase, K2's walk's latency,
#: and gather16, the SSAO / PCF tap gather, have none)
REPLACES = {
    "thread-row": "scripts/bench_pallas_gather.py:88",
    "warp-row": "scripts/bench_pallas_gather.py:88",
    "row-loop": "scripts/bench_pallas_gather.py:125",
    "lane": "scripts/bench_pallas_gather.py:157",
    "rows-acc": "scripts/probe_dyngather.py:63",
    "chase": None,
    "gather16": None,
}
#: the lane walk stages a column in a block's shared memory (csrc's
#: kLaneMaxRows; ``run`` holds the launch to it on the card)
LANE_MAX_ROWS = STAGE_MAX_BYTES // 4

#: the yardstick: 16-byte words a read-rate round covers (csrc's
#: kRateThreads * kRateLoads), a block's L1 slice, blocks an SM, passes
RATE_CHUNK = 512 * 4
RATE_SPAN = RATE_CHUNK  # 32 KB
RATE_BLOCKS_PER_SM = 2
RATE_PASSES = {1: 4000, 2: 500}
#: the latency rings: 128-byte lines (L1: 32 KB; L2: 4 MB), laps to warm, steps
RING_LINES = {1: 256, 2: 32768}
RING_STEPS = 20000
#: the L1 ring again at these sizes (KB): where its latency leaves L1's, the
#: L1 that global loads get is full (l1_fit_bytes: within L1_FIT of the
#: 32 KB ring's latency)
L1_SWEEP_KB = (64, 128, 160, 192, 224, 256)
L1_FIT = 1.1
#: the staging time: copies of rows-acc's N = 256 table a launch
STAGE_REPS = 64
#: kernel launches by kernel name
launches = collections.Counter()


def make_table(n: int, seed: int = 0) -> np.ndarray:
    """(n, 128) float32: standard normal, column 48 a random row id."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((n, 128), dtype=np.float32)
    tab[:, NEXT] = rng.integers(0, n, n)
    return tab


def start_rows(n: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + 1).integers(0, n, w).astype(np.int32)


# ---- plain versions ------------------------------------------------------------
def walk_plain(tab, idx0, steps: int):
    """Final row ids (W,) int32 and each walker's sum of row[0] (W,)."""
    idx = idx0.long()
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=tab.device)
    for _ in range(steps):
        rows = tab[idx]
        acc = acc + rows[:, 0]
        idx = rows[:, NEXT].long()
    return idx.int(), acc


def walk_guarded(tab, idx0, steps: int):
    """walk_plain under the whole-row kernels' rules, on any table: a walker
    stops at a row id outside [0, N) before reading that row (its final id
    is that id), and a row holding +inf sends it to row 0 after it adds
    row[0].  Equal to walk_plain where every id is in range and every value
    finite."""
    n = tab.shape[0]
    idx = idx0.long()
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=tab.device)
    alive = (idx >= 0) & (idx < n)
    for _ in range(steps):
        rows = tab[torch.where(alive, idx, 0)]
        acc = torch.where(alive, acc + rows[:, 0], acc)
        nxt = torch.where(rows.amax(1) == torch.inf, 0, rows[:, NEXT].long())
        idx = torch.where(alive, nxt, idx)
        alive = alive & (idx >= 0) & (idx < n)
    return idx.int(), acc


def guard_table(tab: np.ndarray, seed: int = 0) -> np.ndarray:
    """A copy of `tab` with 16 rows whose next id lies below the table, 16
    above it, and 32 holding +inf in column 77: walk_guarded's cases."""
    out = tab.copy()
    rows = np.random.default_rng(seed + 4).choice(tab.shape[0], 64, replace=False)
    out[rows[:16], NEXT] = -1
    out[rows[16:32], NEXT] = tab.shape[0] + 7
    out[rows[32:], 77] = np.inf
    return out


def lane_plain(tab, idx0, steps: int):
    """Walker i reads column i % 128; idx = (idx + int(v) * 7 + s) mod N."""
    n = tab.shape[0]
    idx = idx0.int()
    cols = torch.arange(idx.shape[0], device=tab.device) % 128
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=tab.device)
    for s in range(steps):
        v = tab[idx.long(), cols]
        acc = acc + v
        idx = torch.remainder(idx + v.to(torch.int32) * 7 + s, n)
    return idx, acc


def lane_table(n: int, seed: int = 0) -> np.ndarray:
    """(n, 128) float32 for the lane walk's modulo: half the values uniform
    in [-1e5, 1e5] (|int(v) * 7 + s| >= N, the `%` path, for most of them),
    the rest standard normal (the compare-and-add path) but for 1% at the
    edges: int(v) * 7 near +-N, and +-3.1e8, whose product with 7 wraps in
    int32."""
    rng = np.random.default_rng(seed + 5)
    tab = rng.standard_normal((n, 128), dtype=np.float32)
    pick = rng.random((n, 128))
    k = (n - 1) // 7
    edges = np.array([k, k + 1, k + 0.5, 3.1e8], np.float32)
    edges = np.concatenate([edges, -edges])
    tab[pick < 0.5] = rng.uniform(-1e5, 1e5, int((pick < 0.5).sum())).astype(np.float32)
    tab[pick > 0.99] = rng.choice(edges, int((pick > 0.99).sum()))
    return tab


def lane_slow_steps(tab, idx0, steps: int) -> int:
    """The lane walk's steps whose |int(v) * 7 + s| >= N: those the kernel's
    modulo takes through `%`."""
    n = tab.shape[0]
    idx = idx0.int()
    cols = torch.arange(idx.shape[0], device=tab.device) % 128
    slow = 0
    for s in range(steps):
        v = tab[idx.long(), cols]
        d = v.to(torch.int32) * 7 + s
        slow += int((d.abs() >= n).sum())
        idx = torch.remainder(idx + d, n)
    return slow


def row_loop_plain(tab, idx0, steps: int):
    """pallas_dyn_slice_loop's function per walker: the ids idx0 themselves
    (they never change) and row[0] of each walker's row added `steps` times
    to 0.0 in float32, in step order.  Raises on an id outside [0, N)."""
    n = tab.shape[0]
    idx = idx0.long()
    if bool(((idx < 0) | (idx >= n)).any()):
        raise ValueError(f"row-loop: start ids lie in [0, {n})")
    v = tab[idx, 0]
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=tab.device)
    for _ in range(steps):
        acc = acc + v
    return idx0, acc


def to_int32(x):
    """float32 -> int32 as jnp's astype and CUDA's __float2int_rz: truncated
    toward 0, saturated to [-2^31, 2^31 - 1], NaN to 0."""
    return x.double().trunc().clamp(-2**31, 2**31 - 1).nan_to_num(0.0).to(torch.int32)


def rows_acc_plain(tab, idx0, steps: int):
    """The TPU op's rule (scripts/probe_dyngather.py): each step walker i
    reads row v mod N (floor modulo into [0, N)), adds it to its (128,)
    float32 sum and takes v = to_int32(row[48]); v starts at idx0[i].  The
    walker never stops; its final id is the last v, unreduced (idx0 itself
    after 0 steps).  Final ids (W,) int32 and sums (W, 128)."""
    n = tab.shape[0]
    idx = idx0.clone()
    acc = torch.zeros((idx.shape[0], 128), dtype=torch.float32, device=tab.device)
    for _ in range(steps):
        rows = tab[torch.remainder(idx.long(), n)]
        acc = acc + rows
        idx = to_int32(rows[:, NEXT])
    return idx, acc


def wrap_table(tab: np.ndarray, seed: int = 0) -> np.ndarray:
    """A copy of `tab` whose column 48 leaves [0, N) in 40 rows: 16 ids
    below 0 (to -5N), 16 at or above N (to 5N), and 8 values with no int32
    (+-inf, NaN, +-3e9, 2^31) or no integer (7.9, -0.5): rows_acc_plain's
    wrap and its conversion rule."""
    n = tab.shape[0]
    out = tab.copy()
    rng = np.random.default_rng(seed + 7)
    rows = rng.choice(n, 40, replace=False)
    out[rows[:16], NEXT] = rng.integers(-5 * n, 0, 16)
    out[rows[16:32], NEXT] = rng.integers(n, 5 * n, 16)
    out[rows[32:], NEXT] = [np.inf, -np.inf, np.nan, 3e9, -3e9, 2.0**31, 7.9, -0.5]
    return out


def walker_rows(tab, idx0, steps: int) -> list[list[int]]:
    """rows_acc_plain's walkers' distinct rows, each walker's in the order
    of their first load (a replay of the walk's ids)."""
    n = tab.shape[0]
    idx = idx0.long()
    read = []
    for _ in range(steps):
        r = torch.remainder(idx, n)
        read.append(r)
        idx = to_int32(tab[r, NEXT]).long()
    if not read:
        return [[] for _ in range(idx0.shape[0])]
    return [list(dict.fromkeys(rows)) for rows in torch.stack(read, 1).tolist()]


def latency_floor(walkers, steps: int, n: int, l1_ns: float, l2_ns: float,
                  smem_ns: float | None = None, stage_ns: float | None = None,
                  l1_bytes: int = L1_BYTES) -> dict:
    """rows-acc's least time: each walker's steps are one chain of
    dependent loads, and a route's time is its slowest walker's.
    `walkers`: each walker's distinct rows (walker_rows).  The floor is the
    lesser of two routes:
      one SM   all walkers on one SM: a row no other walker reads from L2
               (its first load), every other load from L1 (a row another
               walker reads may have reached L1 first).  It ignores L1's
               capacity, so no layout does better, whatever fits;
      shared   where the table (n rows) fits a block's shared memory (n <=
               STAGE_MAX_ROWS) and smem_ns / stage_ns are given: one
               block's bulk copy of it, then steps shared-memory loads.
    Beside it, not part of it (one SM is never above it): each walker on an
    SM of its own, its first load of a row from L2, a later one from L1
    where its rows fit `l1_bytes`, else from L2.
    Returns dict(ms, route, one_sm_ms, shared_ms (None where the table does
    not fit), own_sm_ms, walker_ms (own SM, per walker))."""
    walker_ns = []
    for rows in walkers:
        again = l1_ns if len(rows) * 512 <= l1_bytes else l2_ns
        walker_ns.append(len(rows) * l2_ns + (steps - len(rows)) * again)
    counts = collections.Counter(r for rows in walkers for r in set(rows))
    alone = [sum(counts[r] == 1 for r in rows) for rows in walkers]
    routes = {"one SM": max((k * l2_ns + (steps - k) * l1_ns for k in alone), default=0.0) * 1e-6}
    if n <= STAGE_MAX_ROWS and smem_ns is not None and stage_ns is not None:
        routes["shared"] = (stage_ns + steps * smem_ns) * 1e-6
    route = min(routes, key=routes.get)
    return dict(ms=routes[route], route=route, one_sm_ms=routes["one SM"],
                shared_ms=routes.get("shared"), own_sm_ms=max(walker_ns, default=0.0) * 1e-6,
                walker_ms=[t * 1e-6 for t in walker_ns])


def l1_fit_bytes(sweep: dict, l1_ns: float) -> int:
    """The L1 that global loads get, from the yardstick's L1 ring at
    several sizes (sweep: KB -> ns a step): the largest size whose latency
    is within L1_FIT of l1_ns (the 32 KB ring's), in bytes; 32 KB where
    none is."""
    fit = [kb for kb, ns in sweep.items() if ns <= L1_FIT * l1_ns]
    return max(fit, default=RING_LINES[1] * 128 // 1024) * 1024


def gather16_plain(img, idx):
    """Rows idx of an (H, W, 4) float32 image: (R, 4)."""
    return img.reshape(-1, 4)[idx.long()]


def table_bytes_read(kind: str, tab, idx0, steps: int) -> int:
    """The table bytes walk `kind` must read on this data: the distinct
    rows its walkers visit, 512 bytes each for the whole-row walks (every
    value feeds them), row[0] and row[48] for the chase; the distinct
    (row, column) values for the lane walk; row[0] of each distinct start
    row for row-loop, whose result reads nothing else."""
    n = tab.shape[0]
    if kind == "row-loop":
        return int(torch.unique(idx0).numel()) * 4
    if kind == "lane":
        seen = torch.zeros(n * 128, dtype=torch.bool, device=tab.device)
        idx = idx0.long()
        cols = torch.arange(idx.shape[0], device=tab.device) % 128
        for s in range(steps):
            flat = idx * 128 + cols
            seen[flat] = True
            v = tab.reshape(-1)[flat]
            idx = torch.remainder(idx + v.to(torch.int32).long() * 7 + s, n)
        return int(seen.sum()) * 4
    if kind == "rows-acc":
        return len(set().union(*walker_rows(tab, idx0, steps))) * 512
    seen = torch.zeros(n, dtype=torch.bool, device=tab.device)
    idx = idx0.long()
    for _ in range(steps):
        seen[idx] = True
        idx = tab[idx, NEXT].long()
    return int(seen.sum()) * (8 if kind == "chase" else 512)


def sharing(tab, idx0, steps: int, block: int = SHARE_BLOCK):
    """What walk_plain's walkers share, step by step: ([distinct rows all
    walkers read at step s], [mean distinct rows a block of `block`
    consecutive walkers (start order; the last block may be short) reads at
    step s]).  Exact counts by a replay of the walk."""
    n = tab.shape[0]
    idx = idx0.long()
    blk = torch.arange(idx.shape[0], device=tab.device) // block
    n_blocks = -(-idx.shape[0] // block)
    distinct, per_block = [], []
    for _ in range(steps):
        distinct.append(int(torch.unique(idx).numel()))
        per_block.append(int(torch.unique(blk * n + idx).numel()) / n_blocks)
        idx = tab[idx, NEXT].long()
    return distinct, per_block


def read_rate_plain(tab, level: int, blocks: int, passes: int):
    """Each read-rate block's uint32 sum of the bits it reads (as int64 in
    [0, 2^32)): level 1, block b's RATE_SPAN words at (b % slices) * span,
    `passes` times; level 2, the words x with (x % (blocks * 512)) // 512 ==
    b, `passes` times."""
    words = tab.reshape(-1).view(torch.int32).long() & 0xFFFFFFFF
    per16 = words.reshape(-1, 4).sum(1)
    if level == 1:
        slices = per16.reshape(-1, RATE_SPAN).sum(1)
        b = torch.arange(blocks, device=tab.device) % slices.shape[0]
        sums = slices[b]
    else:
        owner = (torch.arange(per16.shape[0], device=tab.device) % (blocks * 512)) // 512
        sums = torch.zeros(blocks, dtype=torch.int64, device=tab.device).index_add_(
            0, owner, per16)
    return (sums * passes) & 0xFFFFFFFF


def make_ring(lines: int, seed: int = 0):
    """A pointer ring over `lines` 128-byte lines in a random order: (ring
    int32 (lines * 32,), the line order); ring[32 * order[i]] = 32 *
    order[i + 1], so k steps from 32 * order[0] end at 32 * order[k % lines]."""
    order = np.random.default_rng(seed + 3).permutation(lines)
    ring = np.zeros(lines * 32, np.int32)
    ring[order * 32] = np.roll(order, -1) * 32
    return ring, order


# ---- kernels -------------------------------------------------------------------
@functools.cache
def load_kernel():
    lib = load_cuda_library("gather_probe.cu")
    walk = lib.probe_walk_launch
    walk.restype = ctypes.c_int
    walk.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    g16 = lib.probe_gather16_launch
    g16.restype = ctypes.c_int
    g16.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    rate = lib.probe_read_rate_launch
    rate.restype = ctypes.c_int
    rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    chase = lib.probe_latency_launch
    chase.restype = ctypes.c_int
    chase.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    stage = lib.probe_stage_launch
    stage.restype = ctypes.c_int
    stage.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p]
    return walk, g16, rate, chase, stage


def _check_args(name: str, *tensors):
    """Contiguous tensors on one CPU or CUDA device; returns whether it is
    CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: contiguous tensors on one CPU or CUDA device, got "
                             f"{'a contiguous' if t.is_contiguous() else 'a non-contiguous'} "
                             f"tensor on {t.device} beside {dev}")
    return dev.type == "cuda"


def _stream(t):
    index = t.get_device()
    return index, current_stream(index)


def walk(kind: str, tab, idx0, steps: int):
    """Kernel `kind` (thread-row, warp-row, chase, lane, rows-acc or
    row-loop) over the (N, 128) float32 table from the int32 start rows
    idx0.  Its plain version on CPU tensors, its kernel on CUDA tensors; the
    checks hold on both (lane: N <= LANE_MAX_ROWS; rows-acc: N >= 1).
    rows-acc wraps its ids as the TPU op does (rows_acc_plain: row v mod N,
    v = to_int32(row[48]), the final id unreduced), on both.  For the other
    kinds row ids (idx0 and the table's column 48) lie in [0, N): the kernel
    stops a walker at one that does not (its final id is that id), the
    plain version raises.  row-loop returns idx0 itself as its final ids."""
    if kind not in KINDS:
        raise ValueError(f"unknown walk kind {kind!r}; kinds: {sorted(KINDS)}")
    cuda = _check_args(kind, tab, idx0)
    if (tab.dtype != torch.float32 or tab.dim() != 2 or tab.shape[1] != 128
            or idx0.dtype != torch.int32 or idx0.dim() != 1):
        raise ValueError(f"{kind}: a float32 (N, 128) table and (W,) int32 rows, got "
                         f"{tab.dtype} {tuple(tab.shape)} and {idx0.dtype} {tuple(idx0.shape)}")
    if kind == "lane" and tab.shape[0] > LANE_MAX_ROWS:
        raise ValueError(f"lane: a column of {tab.shape[0]} rows does not fit a block's shared "
                         f"memory (at most {LANE_MAX_ROWS} rows)")
    if kind == "rows-acc" and tab.shape[0] == 0:
        raise ValueError("rows-acc: ids wrap mod N, so the table needs a row")
    if not cuda:
        plain = {"lane": lane_plain, "rows-acc": rows_acc_plain,
                 "row-loop": row_loop_plain}.get(kind, walk_plain)
        return plain(tab, idx0, steps)
    w = idx0.shape[0]
    # row-loop's ids never change: its kernel writes the sums alone
    out_idx = (idx0 if kind == "row-loop"
               else torch.empty(w, dtype=torch.int32, device=tab.device))
    out_acc = torch.empty((w, 128) if kind == "rows-acc" else (w,), dtype=torch.float32,
                          device=tab.device)
    index, stream = _stream(tab)
    err = load_kernel()[0](KINDS[kind], tab.data_ptr(), idx0.data_ptr(), w, steps,
                           tab.shape[0], None if kind == "row-loop" else out_idx.data_ptr(),
                           out_acc.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"gather probe {kind} launch failed: CUDA error {err}")
    launches[kind] += 1
    return out_idx, out_acc


def gather16(img, idx):
    """Rows idx (int32) of an (H, W, 4) float32 image: (R, 4).  A row id out
    of range gives NaN from the kernel; the plain version raises."""
    cuda = _check_args("gather16", img, idx)
    if (img.dtype != torch.float32 or img.shape[-1] != 4 or idx.dtype != torch.int32
            or idx.dim() != 1):
        raise ValueError("gather16: a float32 (..., 4) image and (R,) int32 rows")
    if not cuda:
        return gather16_plain(img, idx)
    out = torch.empty((idx.shape[0], 4), dtype=torch.float32, device=img.device)
    index, stream = _stream(img)
    err = load_kernel()[1](img.data_ptr(), img.numel() // 4, idx.data_ptr(), idx.shape[0],
                           out.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"gather probe gather16 launch failed: CUDA error {err}")
    launches["gather16"] += 1
    return out


def read_rate(tab, level: int, blocks: int, passes: int):
    """The yardstick's coalesced read (level 1: L1, level 2: L2) of the
    table on the card: each block's uint32 bit sum, as int64 (blocks,)."""
    _check_args("read rate", tab)
    if not tab.is_cuda or tab.dtype != torch.float32 or tab.numel() % (RATE_CHUNK * 4):
        raise ValueError("read rate: a CUDA float32 table of whole 32 KB chunks")
    out = torch.empty(blocks, dtype=torch.int32, device=tab.device)
    index, stream = _stream(tab)
    err = load_kernel()[2](level, tab.data_ptr(), tab.numel() // 4, RATE_SPAN, passes, blocks,
                           out.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"gather probe read rate launch failed: CUDA error {err}")
    launches["read-rate"] += 1
    return out.long() & 0xFFFFFFFF


def chase_ring(ring, level: int, start: int, warm: int, steps: int):
    """One warp follows the pointer ring on the card: level 1 through L1, 2
    from L2, 3 from shared memory (an int32 ring), 4 rows-acc's step through
    L1 (a float32 ring: its load and fast_row's fixed-latency operations to the
    next address), 5 that step with F2I and the wrap's compare and branch
    (a float32 ring): (final position, ns of the timed steps)."""
    _check_args("chase ring", ring)
    if not ring.is_cuda or ring.dtype != (torch.float32 if level >= 4 else torch.int32):
        raise ValueError("chase ring: a CUDA ring, float32 at levels 4-5, else int32")
    out = torch.zeros(2, dtype=torch.int64, device=ring.device)
    index, stream = _stream(ring)
    err = load_kernel()[3](level, ring.data_ptr(), ring.numel(), start, warm, steps,
                           out.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"gather probe latency launch failed: CUDA error {err}")
    launches["latency"] += 1
    pos, ns = out.tolist()
    return pos, ns


def stage_copy(tab, reps: int):
    """One block copies the float32 table (at most STAGE_MAX_ROWS rows of
    128) into its shared memory with one TMA bulk copy, `reps` times in
    turn, on the card: (uint32 sum of the staged bits as int, ns a copy)."""
    _check_args("stage copy", tab)
    if not tab.is_cuda or tab.dtype != torch.float32 or not 0 < tab.numel() <= STAGE_MAX_ROWS * 128:
        raise ValueError("stage copy: a CUDA float32 table of at most STAGE_MAX_ROWS rows")
    out = torch.zeros(2, dtype=torch.int64, device=tab.device)
    index, stream = _stream(tab)
    err = load_kernel()[4](tab.data_ptr(), tab.numel() * 4, reps, out.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"gather probe stage copy launch failed: CUDA error {err}")
    launches["stage"] += 1
    bits, ns = out.tolist()
    return bits & 0xFFFFFFFF, ns / reps


# ---- the probe -----------------------------------------------------------------
def _cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Milliseconds of one fn() on the device alone: `calls` calls captured
    in one CUDA graph, the graph replayed `replays` times (and once before
    the timing), so the host's launch path (Python, ctypes) is left out.
    ``launches`` counts what ran: a captured call counts once for each
    replay, not for its capture."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = launches.copy()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    captured = launches - before
    ms = _cuda_ms(graph.replay, replays) / calls
    for name, count in captured.items():
        launches[name] += count * replays  # the capture counted one replay's
    del graph
    return ms


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _clock_under_load(launch, ms: float, seconds: float = 2.0) -> list[float]:
    """The SM clocks (MHz) nvidia-smi reports while `launch` (one launch of
    `ms` milliseconds) runs: about `seconds` of launches are queued and the
    clock is read again and again; a reading counts only if the queue was
    still busy when it returned."""
    for _ in range(3):
        for _ in range(max(1, int(seconds * 1e3 / ms))):
            launch()
        done = torch.cuda.Event()
        done.record()
        clocks = []
        while True:
            mhz = float(_smi("clocks.sm").split()[0])
            if done.query():
                break
            clocks.append(mhz)
        if clocks:
            return clocks
        seconds *= 2
    raise RuntimeError("gather probe: the queued reads drained before nvidia-smi read the SM clock")


def yardstick(tab, out=print) -> dict:
    """The delivered L1 and L2 read rates over `tab` (checked against
    read_rate_plain), the SM clock nvidia-smi reports under the L1 read, the
    dependent-load latency in L1 and in L2; printed, and returned."""
    dev = tab.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = RATE_BLOCKS_PER_SM * n_sm
    rates = {}
    for level in (1, 2):
        passes = RATE_PASSES[level]
        got = read_rate(tab, level, blocks, passes)
        if not torch.equal(got, read_rate_plain(tab, level, blocks, passes)):
            raise RuntimeError(f"gather probe read rate L{level}: kernel and plain sum differ")
        ms = _cuda_ms(lambda: read_rate(tab, level, blocks, passes), 5)
        read = blocks * RATE_SPAN * 16 if level == 1 else tab.numel() * 4
        rates[level] = (read * passes / (ms * 1e-3), ms)
    clocks = _clock_under_load(lambda: read_rate(tab, 1, blocks, RATE_PASSES[1]), rates[1][1])
    clock_mhz = min(clocks)
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    per_clk = {lv: r / (n_sm * clock_mhz * 1e6) for lv, (r, _) in rates.items()}
    out(f"yardstick: coalesced 16-byte reads, {blocks} blocks of 512 threads, bit sums equal "
        f"to the plain sum; SM clock under the L1 read {clock_mhz:.0f} MHz (the least of "
        f"{len(clocks)} readings taken while the reads ran; max {max_mhz:.0f}), {n_sm} SMs")
    out(f"  L1-resident read: each block {RATE_PASSES[1]} passes over its own "
        f"{RATE_SPAN * 16} bytes: {rates[1][1]:.4f} ms, {rates[1][0] / 1e12:.3f} TB/s, "
        f"{per_clk[1]:.2f} bytes a clock an SM")
    out(f"  L2-resident read: all blocks {RATE_PASSES[2]} passes over the {tab.numel() * 4}-byte "
        f"table (ld.cg): {rates[2][1]:.4f} ms, {rates[2][0] / 1e12:.3f} TB/s, "
        f"{per_clk[2]:.2f} bytes a clock an SM")
    lat = {}
    for level in (1, 2):
        lines = RING_LINES[level]
        ring_np, order = make_ring(lines)
        ring = torch.from_numpy(ring_np).to(dev)
        pos, ns = chase_ring(ring, level, int(order[0]) * 32, lines, RING_STEPS)
        if pos != int(order[(lines + RING_STEPS) % lines]) * 32:
            raise RuntimeError(f"gather probe latency L{level}: the chase ended at {pos}")
        lat[level] = ns / RING_STEPS
    # the L1 ring's lines from shared memory, and rows-acc's step through L1
    # (the ring's entries as float32), with fast_row and with F2I
    lines = RING_LINES[1]
    ring_np, order = make_ring(lines)
    for level, ring in ((3, ring_np), (4, ring_np.astype(np.float32)),
                        (5, ring_np.astype(np.float32))):
        pos, ns = chase_ring(torch.from_numpy(ring).to(dev), level, int(order[0]) * 32, lines,
                             RING_STEPS)
        if pos != int(order[(lines + RING_STEPS) % lines]) * 32:
            raise RuntimeError(f"gather probe latency level {level}: the chase ended at {pos}")
        lat[level] = ns / RING_STEPS
    out(f"  dependent-load latency, one warp, {RING_STEPS} steps after a lap: L1 ring "
        f"({RING_LINES[1] * 128} bytes, ld.ca) {lat[1]:.2f} ns a step, L2 ring "
        f"({RING_LINES[2] * 128} bytes, ld.cg) {lat[2]:.2f} ns a step, the L1 ring's lines in "
        f"shared memory {lat[3]:.2f} ns a step; rows-acc's step through L1 (its load, "
        f"fast_row, the address) {lat[4]:.2f} ns a step, "
        f"{(lat[4] - lat[1]) * clock_mhz * 1e-3:.1f} clocks over the L1 load's at "
        f"{clock_mhz:.0f} MHz; the step with F2I and the wrap's compare and branch instead "
        f"{lat[5]:.2f} ns, {(lat[5] - lat[1]) * clock_mhz * 1e-3:.1f} clocks over; each ends "
        f"as the replay's")
    sweep = {}
    for kb in L1_SWEEP_KB:
        lines = kb * 1024 // 128
        ring_np, order = make_ring(lines)
        pos, ns = chase_ring(torch.from_numpy(ring_np).to(dev), 1, int(order[0]) * 32, lines,
                             RING_STEPS)
        if pos != int(order[(lines + RING_STEPS) % lines]) * 32:
            raise RuntimeError(f"gather probe latency, {kb} KB L1 ring: the chase ended at {pos}")
        sweep[kb] = ns / RING_STEPS
    l1_fit = l1_fit_bytes(sweep, lat[1])
    out("  the L1 ring (ld.ca) at larger sizes, ns a step: "
        + ", ".join(f"{kb} KB {ns:.2f}" for kb, ns in sweep.items())
        + f" (L1's latency while the ring stays in the L1 that global loads get): global "
        f"loads get {l1_fit} bytes of L1 (the largest ring within {L1_FIT}x the 32 KB ring's)")
    staged = tab[:ROWS_ACC_N[0]]
    bits, stage_ns = stage_copy(staged, STAGE_REPS)
    if bits != int((staged.view(torch.int32).long() & 0xFFFFFFFF).sum()) & 0xFFFFFFFF:
        raise RuntimeError("gather probe stage copy: the staged bits' sum differs from the table's")
    out(f"  one block's TMA bulk copy of rows-acc's N = {ROWS_ACC_N[0]} table ({staged.numel() * 4} "
        f"bytes, from L2) into its shared memory: {stage_ns:.2f} ns ({STAGE_REPS} copies in turn "
        f"a launch); the staged bits' sum equals the table's")
    return dict(l1_rate=rates[1][0], l2_rate=rates[2][0], l1_per_clk=per_clk[1],
                l2_per_clk=per_clk[2], clock_mhz=clock_mhz, max_mhz=max_mhz, n_sm=n_sm,
                l1_ns=lat[1], l2_ns=lat[2], smem_ns=lat[3], step_ns=lat[4], f2i_step_ns=lat[5],
                l1_sweep=sweep, l1_fit=l1_fit, stage_ns=stage_ns)


def turns(other, mine, iters: int) -> list[float]:
    """Milliseconds of two launches (functions of no argument) timed in
    turns: other, mine, mine, other."""
    return [_cuda_ms(fn, iters) for fn in (other, mine, mine, other)]


def graph_turns(fns, calls: int = 20, replays: int = 5) -> list[list[float]]:
    """Milliseconds of one call of each fn on the device alone: each fn's
    `calls` calls captured in a CUDA graph of its own, the graphs replayed
    in turns, in order and then in reverse (other, mine, mine, other for
    two): [[first, second] for each fn].  ``launches`` counts the replays."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graphs = []
    for fn in fns:
        graph = torch.cuda.CUDAGraph()
        before = launches.copy()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        captured = launches - before
        launches.subtract(captured)
        graphs.append((graph, captured))
    times = [[] for _ in fns]
    for i in [*range(len(fns)), *reversed(range(len(fns)))]:
        graph, captured = graphs[i]
        times[i].append(_cuda_ms(graph.replay, replays) / calls)
        for name, count in captured.items():
            launches[name] += count * (replays + 1)
    return times


def _out_of_table_starts(idx0, n: int, seed: int):
    """A copy of idx0 with 16 ids below the table and 16 above it, and the
    mask of those 32 walkers."""
    ids = idx0.clone()
    rows = torch.from_numpy(np.random.default_rng(seed + 6).choice(ids.shape[0], 32,
                                                                    replace=False)).to(ids.device)
    ids[rows[:16]] = -1 - rows[:16].int()
    ids[rows[16:]] = n + rows[16:].int()
    bad = torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device)
    bad[rows] = True
    return ids, bad


def run(seed: int = 0, out=print, parent=None) -> dict[str, dict]:
    """Every case on the current CUDA device; raises if a kernel and its
    plain version differ.  Returns, per kernel, its numbers at the case
    that stands for it (rows 3-5 and the chase at the frame's width, row 6
    at N = 20480).  parent(kind, tab, idx0, steps) -> (ids, sums): another
    build's walk launch; its thread-row, warp-row, lane and rows-acc are
    checked against the plain versions and timed in turns with this
    build's (rows-acc in CUDA graphs)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probe measures the card: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    tab_np = make_table(N_ROWS, seed)
    tab = torch.from_numpy(tab_np).to(dev)
    ys = yardstick(tab, out)
    l1_rate = ys["l1_rate"]
    fp32_per_s = ys["n_sm"] * 128 * ys["max_mhz"] * 1e6
    lookups_per_s = ys["n_sm"] * ys["clock_mhz"] * 1e6
    out(f"bound: each distinct value a walk reads once at the HBM rate "
        f"({HBM_BYTES_PER_S / 1e12:.2f} TB/s, data sheet), or its float32 adds at "
        f"{fp32_per_s / 1e12:.2f} T FP32 instructions/s ({ys['n_sm']} SMs x 128 lanes x "
        f"{ys['max_mhz']:.0f} MHz), the larger; L1 ceiling: the gathered bytes at the "
        f"delivered L1 rate, {l1_rate / 1e12:.3f} TB/s (a delivered rate, not the bound); "
        f"row-loop's modelled ceiling: one line lookup a clock an SM at {ys['clock_mhz']:.0f} "
        f"MHz (a model, not the bound)")
    results = {}

    def case(label, idx0, steps, step_bytes, kernel, plain, read_bytes, out_bytes, adds,
             library=False, model=False):
        w = idx0.shape[0]
        got, ref = kernel(), plain()
        _check_equal(label, got, ref)
        ms = _cuda_ms(kernel, 5 if w > W_PROBE else 20)
        graph_ms = _graph_ms(kernel)
        plain_ms = _cuda_ms(plain, 1 if w > W_PROBE else 3)
        n_idx = w * steps
        gathered = n_idx * step_bytes
        # the bound: the table bytes this run's walk reads (read_bytes, each
        # once), the start ids read once, the outputs written once (row-loop
        # writes its sums alone); or its
        # float32 adds at the FP32 rate
        bytes_ms = (read_bytes + idx0.numel() * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = adds / fp32_per_s * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        if model:
            ceiling_ms = n_idx / lookups_per_s * 1e3
            ceiling = (f"modelled ceiling {ceiling_ms:.4f} ms ({n_idx} line lookups at one a "
                       f"clock an SM; share {ceiling_ms / ms:.4f}, of a model, not the bound"
                       + ("; the kernel beats it, so the model is wrong" if ms < ceiling_ms
                          else "") + ")")
        else:
            ceiling_ms = gathered / l1_rate * 1e3
            ceiling = (f"L1 ceiling {ceiling_ms:.4f} ms ({gathered} gathered bytes at the "
                       f"delivered L1 rate; share {ceiling_ms / ms:.4f}, of a delivered rate, "
                       f"not the bound)")
        out(f"  {label}: kernel {ms:.4f} ms (in a CUDA graph {graph_ms:.4f} ms a launch), "
            f"{ms * 1e6 / n_idx:.3f} ns/index, "
            f"{gathered / (ms * 1e-3) / 1e9:.1f} GB/s gathered; plain (PyTorch indexing) "
            f"{plain_ms:.4f} ms; bound {bound_ms:.6f} ms (set by {bound_by}: {read_bytes} table "
            f"bytes read, ids and outputs once, at the HBM rate {bytes_ms:.6f} ms; {adds} float32 "
            f"adds {ops_ms:.6f} ms; share {bound_ms / ms:.4f}); {ceiling}; equal bit for bit")
        return dict(max_abs_err=0.0, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=plain_ms if library else None)

    plains = {"lane": lane_plain, "row-loop": row_loop_plain}
    rows = {"thread-row": 3, "warp-row": 3, "row-loop": 4, "lane": 5}
    big = torch.from_numpy(lane_table(N_ROWS, seed)).to(dev)
    for w, steps in ((W_PROBE, STEPS_PROBE), (W_FRAME, STEPS_FRAME)):
        idx0 = torch.from_numpy(start_rows(N_ROWS, w, seed)).to(dev)
        out(f"walks, W = {w} walkers x {steps} steps, N = {N_ROWS}:")
        if w == W_FRAME:
            distinct, per_block = sharing(tab, idx0, steps)
            out(f"  shared rows (replay): distinct rows all walkers read, step 0..{steps - 1}: "
                f"{distinct}; mean distinct rows a {SHARE_BLOCK}-walker block reads (start "
                f"order): {[round(x, 2) for x in per_block]}")
        for kind, step_bytes in (("thread-row", 512), ("warp-row", 512), ("row-loop", 4),
                                 ("lane", 4), ("chase", 8)):
            plain = plains.get(kind, walk_plain)
            label = (f"{kind} (row {rows[kind]})" if kind in rows else f"{kind} (no TPU row)")
            res = case(label + (", 16 lanes a walker" if kind == "warp-row" else ""),
                       idx0, steps, step_bytes,
                       lambda k=kind: walk(k, tab, idx0, steps),
                       lambda p=plain: p(tab, idx0, steps),
                       table_bytes_read(kind, tab, idx0, steps),
                       w * (4 if kind == "row-loop" else 8), w * steps,
                       model=kind == "row-loop")
            if w == W_FRAME:
                results[kind] = res
        # the lane walk's fixed part: the columns staged, the ids read and the
        # outputs written, no step
        _check_equal(f"lane, 0 steps, W = {w}", walk("lane", tab, idx0, 0),
                     lane_plain(tab, idx0, 0))
        fixed = _cuda_ms(lambda: walk("lane", tab, idx0, 0), 5 if w > W_PROBE else 20)
        fixed_graph = _graph_ms(lambda: walk("lane", tab, idx0, 0))
        out(f"  lane with 0 steps (the transposes in and out, the columns staged): {fixed:.4f} "
            f"ms (in a CUDA graph {fixed_graph:.4f} ms); equal bit for bit")
        # the modulo's `%` path: lane_table's values reach +-1e5
        _check_equal(f"lane on the large-value table, W = {w}", walk("lane", big, idx0, steps),
                     lane_plain(big, idx0, steps))
        out(f"  lane on lane_table (values to +-1e5): equal to lane_plain bit for bit; "
            f"{lane_slow_steps(big, idx0, steps)} of {w * steps} steps took the `%` path")
        if parent is not None:
            for kind in ("thread-row", "warp-row", "lane"):
                plain = plains.get(kind, walk_plain)
                _check_equal(f"the parent's {kind}, W = {w}",
                             parent(KINDS[kind], tab, idx0, steps), plain(tab, idx0, steps))
                t = turns(lambda k=kind: parent(KINDS[k], tab, idx0, steps),
                          lambda k=kind: walk(k, tab, idx0, steps), 5 if w > W_PROBE else 20)
                out(f"  {kind} against the parent's, in turns (parent, this, this, parent): "
                    f"{t[0]:.4f} / {t[3]:.4f} ms against {t[1]:.4f} / {t[2]:.4f} ms: "
                    f"{(t[0] + t[3]) / (t[1] + t[2]):.3f}x; both equal to the plain walk")
    # row 3's walks where ids leave the table and rows hold +inf
    guarded = torch.from_numpy(guard_table(tab_np, seed)).to(dev)
    idx0 = torch.from_numpy(start_rows(N_ROWS, W_PROBE, seed)).to(dev)
    ref = walk_guarded(guarded, idx0, STEPS_PROBE)
    stopped = int(((ref[0] < 0) | (ref[0] >= N_ROWS)).sum())
    if stopped == 0:
        raise RuntimeError("gather probe: no walker left the guard table")
    for kind in ("thread-row", "warp-row"):
        _check_equal(f"{kind} on the guard table", walk(kind, guarded, idx0, STEPS_PROBE), ref)
    out(f"guard table (ids outside the table, rows holding +inf), W = {W_PROBE} x "
        f"{STEPS_PROBE}: thread-row and warp-row equal to walk_guarded bit for bit; {stopped} "
        f"walkers stopped at an id outside the table")
    # row-loop and lane from start ids outside the table: that id, sum 0
    ids, bad = _out_of_table_starts(idx0, N_ROWS, seed)
    for kind in ("row-loop", "lane"):
        ref_idx, ref_acc = plains[kind](tab, torch.where(bad, 0, ids), STEPS_PROBE)
        _check_equal(f"{kind} from ids outside the table", walk(kind, tab, ids, STEPS_PROBE),
                     (torch.where(bad, ids, ref_idx), torch.where(bad, 0.0, ref_acc)))
    out(f"row-loop and lane from {int(bad.sum())} start ids outside the table: those walkers "
        f"keep their ids with sum 0, the others equal the plain walk bit for bit")
    # lane's column limit is the launch's own: a table of LANE_MAX_ROWS rows
    # walks, and the launch refuses one row more before it reads anything
    edge = torch.from_numpy(lane_table(LANE_MAX_ROWS, seed)).to(dev)
    _check_equal(f"lane at N = {LANE_MAX_ROWS}", walk("lane", edge, idx0, STEPS_PROBE),
                 lane_plain(edge, idx0, STEPS_PROBE))
    index, stream = _stream(edge)
    sink = torch.empty(2, W_PROBE, dtype=torch.int32, device=dev)
    err = load_kernel()[0](KINDS["lane"], edge.data_ptr(), idx0.data_ptr(), W_PROBE, 1,
                           LANE_MAX_ROWS + 1, sink[0].data_ptr(), sink[1].data_ptr(), index,
                           stream)
    if err != 1:  # cudaErrorInvalidValue
        raise RuntimeError(f"gather probe: the lane launch gave {err} for a column of "
                           f"{LANE_MAX_ROWS + 1} rows, not cudaErrorInvalidValue (1)")
    out(f"lane at N = LANE_MAX_ROWS = {LANE_MAX_ROWS} (lane_table): equal to lane_plain bit for "
        f"bit; the launch refuses N = {LANE_MAX_ROWS + 1} (cudaErrorInvalidValue)")
    rows_acc_section(dev, seed, ys, case, results, out, parent)
    rng = np.random.default_rng(seed + 2)
    img = torch.from_numpy(rng.standard_normal((1080, 1920, 4), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 1080 * 1920, 1080 * 1920).astype(np.int32)).to(dev)
    out("gather16: 2,073,600 random 16-byte rows of a 1920x1080x4 float32 image:")
    results["gather16"] = case("gather16 (img[idx])", idx, 1, 16,
                               lambda: gather16(img, idx), lambda: gather16_plain(img, idx),
                               int(torch.unique(idx).numel()) * 16, idx.numel() * 16, 0,
                               library=True)
    return results


def rows_acc_section(dev, seed, ys, case, results, out, parent=None):
    """run's rows-acc (row 6) cases: at each N the kernel against
    rows_acc_plain bit for bit, each walker's distinct rows, the latency
    floor with its shares, beside it the own-SM route and the union floor
    (every step at the level that holds the union of the walkers' rows)
    with theirs, and with `parent` the parent's rows-acc in turns in CUDA
    graphs; then the wrap table on both routes."""
    out(f"rows-acc (row 6), S = {ROWS_ACC_S} warp walkers x {STEPS_PROBE} steps, row v mod N "
        f"(v = row[48] truncated to int32), the final id unreduced:")
    for n in ROWS_ACC_N:
        t = torch.from_numpy(make_table(n, seed)).to(dev)
        idx0 = torch.from_numpy(start_rows(n, ROWS_ACC_S, seed)).to(dev)
        walkers = walker_rows(t, idx0, STEPS_PROBE)
        read = len(set().union(*walkers)) * 512
        res = results["rows-acc"] = case(
            f"N = {n} ({n * 512} bytes)", idx0, STEPS_PROBE, 512,
            lambda: walk("rows-acc", t, idx0, STEPS_PROBE),
            lambda: rows_acc_plain(t, idx0, STEPS_PROBE),
            read, ROWS_ACC_S * (4 + 512), ROWS_ACC_S * STEPS_PROBE * 128)
        floor = latency_floor(walkers, STEPS_PROBE, n, ys["l1_ns"], ys["l2_ns"], ys["smem_ns"],
                              ys["stage_ns"], ys["l1_fit"])
        level = 1 if read <= L1_BYTES else 2
        old_ms = STEPS_PROBE * (ys["l1_ns"] if level == 1 else ys["l2_ns"]) * 1e-6
        res.update(floor_ms=floor["ms"], old_floor_ms=old_ms)

        def shares(ms):
            return f"share {ms / res['ms']:.4f} (a launch), {ms / res['graph_ms']:.4f} (in a CUDA graph)"

        shared = ("" if floor["shared_ms"] is None else
                  f"; shared: one block's bulk copy {ys['stage_ns']:.2f} ns + {STEPS_PROBE} x the "
                  f"shared-memory latency {ys['smem_ns']:.2f} ns = {floor['shared_ms']:.4f} ms")
        out(f"    each walker's distinct rows (first loads, from L2): {[len(r) for r in walkers]}; "
            f"union {read} bytes")
        out(f"    latency floor ({floor['route']}) {floor['ms']:.4f} ms, the lesser of: one SM (rows "
            f"no other walker reads at L2 {ys['l2_ns']:.2f} ns, the rest at L1 {ys['l1_ns']:.2f} "
            f"ns; L1's capacity ignored) {floor['one_sm_ms']:.4f} ms{shared}; "
            f"{shares(floor['ms'])}")
        out(f"    beside it, each walker on an SM of its own (its first loads at L2, the rest at L1 "
            f"where its rows fit the {ys['l1_fit']} bytes of L1 global loads get, else L2): "
            f"{floor['own_sm_ms']:.4f} ms (walkers {[round(x, 4) for x in floor['walker_ms']]}); "
            f"{shares(floor['own_sm_ms'])}")
        out(f"    the union floor, {STEPS_PROBE} steps x the L{level} latency (the union "
            f"{'fits' if level == 1 else 'exceeds'} {L1_BYTES} bytes): {old_ms:.4f} ms; "
            f"{shares(old_ms)}")
        if parent is not None:
            _check_equal(f"the parent's rows-acc, N = {n}",
                         parent(KINDS["rows-acc"], t, idx0, STEPS_PROBE),
                         rows_acc_plain(t, idx0, STEPS_PROBE))
            tt = graph_turns([lambda: parent(KINDS["rows-acc"], t, idx0, STEPS_PROBE),
                              lambda: walk("rows-acc", t, idx0, STEPS_PROBE)])
            res.update(parent_ms=tt[0], this_ms=tt[1])
            out(f"    against the parent's, in turns in CUDA graphs (parent, this, this, parent): "
                f"{tt[0][0]:.4f} / {tt[0][1]:.4f} ms against {tt[1][0]:.4f} / {tt[1][1]:.4f} ms: "
                f"{sum(tt[0]) / sum(tt[1]):.3f}x; both equal to rows_acc_plain")
    # ids that leave the table, and values with no int32: the TPU op's mod N,
    # on the staged route (N = 256) and the global one (N = 2048)
    for n in ROWS_ACC_N[:2]:
        wt_np = wrap_table(make_table(n, seed), seed)
        wt = torch.from_numpy(wt_np).to(dev)
        col = wt_np[:, NEXT]
        odd = ~((col >= 0) & (col < n) & (col == np.trunc(col)))
        for w in (ROWS_ACC_S, W_PROBE):
            idx0 = torch.from_numpy(start_rows(n, w, seed)).to(dev)
            if w >= 32:
                idx0 = _out_of_table_starts(idx0, n, seed)[0]
            hits = sum(int(odd[rows].sum()) for rows in walker_rows(wt, idx0, STEPS_PROBE))
            if hits == 0:
                raise RuntimeError(f"gather probe: no rows-acc walker read a row whose id leaves "
                                   f"the N = {n} table")
            got, ref = walk("rows-acc", wt, idx0, STEPS_PROBE), rows_acc_plain(wt, idx0, STEPS_PROBE)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, ref)):
                raise RuntimeError(f"gather probe rows-acc on the wrap table, N = {n}, W = {w}: "
                                   f"kernel and plain version differ")
            out(f"rows-acc on wrap_table (N = {n}, the {'staged' if n <= STAGE_MAX_ROWS else 'global'} "
                f"route; column 48 below 0, at or above N, +-inf, NaN, +-3e9, 2^31, 7.9, -0.5), "
                f"W = {w}{' (32 start ids outside the table)' * (w >= 32)}: equal to rows_acc_plain "
                f"bit for bit (NaN too); {hits} of the walkers' distinct rows hold such an id")


def _check_equal(label, got, ref):
    if isinstance(got, tuple):
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
    else:
        same = torch.equal(got, ref)
    if not same:
        raise RuntimeError(f"gather probe {label}: kernel and plain version differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

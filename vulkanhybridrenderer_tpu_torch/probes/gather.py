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
of gathered bytes, the bound (each distinct row read once at the HBM rate)
and the walk's price in 32-byte sectors at the L2 read rate it measures (16
a step for a whole row, 2 for the chase, 1 for a lane's word or a 16-byte
row).  That rate is one library reduction over the table, a read short
enough for its launch to set it, so the price is no bound of a walk: the
probes still want a yardstick they cannot beat.  The cases:
  walk         the plain version and the library call: ``tab[idx]`` per step;
  thread-row   (row 3) a thread per walker reading the whole 512-byte row;
  warp-row     (row 3) a warp per walker reading the row coalesced;
  chase        (row 4) a thread per walker reading row[0] and row[48] only;
  lane         (row 5) out[i] = tab[idx_i, i % 128], idx = (idx + v*7 + s) mod N;
  rows-acc     (row 6) S = 8 warp walkers adding whole rows, N = 256, 2048,
               20480 (128 KB, 1 MB, 10.5 MB: L1, L2, L2);
  gather16     2,073,600 random 16-byte rows of a 1920x1080x4 image.
Rows 3-5 run at the TPU probe's W = 1024 walkers x 512 steps and at the
frame's width, W = 2,073,600 x 32 steps, the occupancy K2 runs at.  On CPU
tensors every wrapper runs its plain version; ``run`` needs the card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import functools

import numpy as np
import torch

N_ROWS = 20480  # the TPU probe's table: 10.5 MB, SponzaProxy's BVH8 size
W_PROBE, STEPS_PROBE = 1024, 512
W_FRAME, STEPS_FRAME = 1920 * 1080, 32
ROWS_ACC_S, ROWS_ACC_N = 8, (256, 2048, 20480)
NEXT = 48  # the column holding the next row id
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
L2_BYTES = 50 * 2**20  # H100 L2 (NVIDIA data sheet)

#: walk kernel -> its kind in csrc/gather_probe.cu's probe_walk_launch
KINDS = {"thread-row": 0, "warp-row": 1, "chase": 2, "lane": 3, "rows-acc": 4}
#: kernel -> the TPU kernel it stands for (gather16, the SSAO / PCF tap
#: gather, has none)
REPLACES = {
    "thread-row": "scripts/bench_pallas_gather.py:88",
    "warp-row": "scripts/bench_pallas_gather.py:88",
    "chase": "scripts/bench_pallas_gather.py:125",
    "lane": "scripts/bench_pallas_gather.py:157",
    "rows-acc": "scripts/probe_dyngather.py:63",
    "gather16": None,
}
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


def rows_acc_plain(tab, idx0, steps: int):
    """Final row ids (W,) and each walker's elementwise sum of its rows
    (W, 128)."""
    idx = idx0.long()
    acc = torch.zeros((idx.shape[0], 128), dtype=torch.float32, device=tab.device)
    for _ in range(steps):
        rows = tab[idx]
        acc = acc + rows
        idx = rows[:, NEXT].long()
    return idx.int(), acc


def gather16_plain(img, idx):
    """Rows idx of an (H, W, 4) float32 image: (R, 4)."""
    return img.reshape(-1, 4)[idx.long()]


def table_bytes_read(kind: str, tab, idx0, steps: int) -> int:
    """The table bytes walk `kind` must read on this data: the distinct
    rows its walkers visit, 512 bytes each for the whole-row walks (every
    value feeds them), row[0] and row[48] for the chase; the distinct
    (row, column) values for the lane walk."""
    n = tab.shape[0]
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
    seen = torch.zeros(n, dtype=torch.bool, device=tab.device)
    idx = idx0.long()
    for _ in range(steps):
        seen[idx] = True
        idx = tab[idx, NEXT].long()
    return int(seen.sum()) * (8 if kind == "chase" else 512)


# ---- kernels -------------------------------------------------------------------
@functools.cache
def load_kernel():
    from vulkanhybridrenderer_tpu_torch.utils.build import load_cuda_library

    lib = load_cuda_library("gather_probe.cu")
    walk = lib.probe_walk_launch
    walk.restype = ctypes.c_int
    walk.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 3)
    g16 = lib.probe_gather16_launch
    g16.restype = ctypes.c_int
    g16.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                    + [ctypes.c_void_p] * 2)
    return walk, g16


def _check_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous CUDA tensors, got {t.device}")


def walk(kind: str, tab, idx0, steps: int):
    """Kernel `kind` (thread-row, warp-row, chase, lane or rows-acc) over the
    (N, 128) float32 table from the int32 start rows idx0; its plain version
    on CPU tensors.  Row ids (idx0 and the table's column 48) lie in [0, N):
    the kernel stops a walker at one that does not, the plain version
    raises."""
    if kind not in KINDS:
        raise ValueError(f"unknown walk kind {kind!r}; kinds: {sorted(KINDS)}")
    if tab.device.type == "cpu":
        plain = {"lane": lane_plain, "rows-acc": rows_acc_plain}.get(kind, walk_plain)
        return plain(tab, idx0, steps)
    _check_cuda(kind, tab, idx0)
    if (tab.dtype != torch.float32 or tab.dim() != 2 or tab.shape[1] != 128
            or idx0.dtype != torch.int32 or idx0.dim() != 1):
        raise ValueError(f"{kind}: a float32 (N, 128) table and (W,) int32 rows")
    w = idx0.shape[0]
    out_idx = torch.empty(w, dtype=torch.int32, device=tab.device)
    out_acc = torch.empty((w, 128) if kind == "rows-acc" else (w,), dtype=torch.float32,
                          device=tab.device)
    fn, _ = load_kernel()
    with torch.cuda.device(tab.device):
        err = fn(KINDS[kind], tab.data_ptr(), idx0.data_ptr(), w, steps, tab.shape[0],
                 out_idx.data_ptr(), out_acc.data_ptr(),
                 torch.cuda.current_stream(tab.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather probe {kind} launch failed: CUDA error {err}")
    launches[kind] += 1
    return out_idx, out_acc


def gather16(img, idx):
    """Rows idx (int32) of an (H, W, 4) float32 image: (R, 4).  A row id out
    of range gives NaN from the kernel; the plain version raises."""
    if img.device.type == "cpu":
        return gather16_plain(img, idx)
    _check_cuda("gather16", img, idx)
    if (img.dtype != torch.float32 or img.shape[-1] != 4 or idx.dtype != torch.int32
            or idx.dim() != 1):
        raise ValueError("gather16: a float32 (..., 4) image and (R,) int32 rows")
    out = torch.empty((idx.shape[0], 4), dtype=torch.float32, device=img.device)
    _, fn = load_kernel()
    with torch.cuda.device(img.device):
        err = fn(img.data_ptr(), img.numel() // 4, idx.data_ptr(), idx.shape[0],
                 out.data_ptr(), torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather probe gather16 launch failed: CUDA error {err}")
    launches["gather16"] += 1
    return out


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


def run(seed: int = 0, out=print) -> dict[str, dict]:
    """Every case on the current CUDA device; raises if a kernel and its
    plain version differ.  Returns, per kernel, its numbers at the case
    that stands for it (rows 3-5 at the frame's width, row 6 at N = 20480)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probe measures the card: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    tab_np = make_table(N_ROWS, seed)
    tab = torch.from_numpy(tab_np).to(dev)
    # the L2 read rate, measured on the resident 10.5 MB table: one library
    # reduction, short enough for its launch to set its time, so it is below
    # the L2's peak and prices no walk from below
    l2_ms = _cuda_ms(lambda: tab.sum(), 50)
    l2_rate = tab.numel() * 4 / (l2_ms * 1e-3)
    out(f"probe: table ({N_ROWS}, 128) float32, {tab.numel() * 4} bytes; L2 read rate "
        f"{l2_rate / 1e12:.3f} TB/s (torch.sum over the resident table, {l2_ms:.4f} ms; "
        f"set by the launch at this size: no bound of a walk); HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet)")
    results = {}

    def case(label, table, idx0, steps, step_bytes, kernel, plain, read_bytes, out_bytes,
             sectors):
        w = idx0.shape[0]
        got, ref = kernel(), plain()
        _check_equal(label, got, ref)
        ms = _cuda_ms(kernel, 5 if w > W_PROBE else 20)
        plain_ms = _cuda_ms(plain, 1 if w > W_PROBE else 3)
        n_idx = w * steps
        gathered = n_idx * step_bytes
        table_bytes = table.numel() * 4
        # the bound: the table bytes this run's walk reads (read_bytes, each
        # once), the start ids read once, the outputs written once
        bound_ms = (read_bytes + idx0.numel() * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
        rate = l2_rate if table_bytes <= L2_BYTES else HBM_BYTES_PER_S
        gathered_ms = gathered / rate * 1e3
        # the walk's price in 32-byte sectors: `sectors` a step (16 for a
        # whole row, 2 for the chase's two words, 1 for a lane's word or a
        # 16-byte row), each at the measured rate
        sector_ms = n_idx * sectors * 32 / rate * 1e3
        where = "L2" if rate == l2_rate else "HBM"
        out(f"  {label}: kernel {ms:.4f} ms, {ms * 1e6 / n_idx:.3f} ns/index, "
            f"{gathered / (ms * 1e-3) / 1e9:.1f} GB/s gathered; plain (PyTorch indexing) "
            f"{plain_ms:.4f} ms, {plain_ms * 1e6 / n_idx:.3f} ns/index; bound {bound_ms:.4f} ms "
            f"({read_bytes} table bytes read, ids and outputs once, at the HBM rate), "
            f"gathered bytes at the {where} rate {gathered_ms:.4f} ms; {sectors} sectors a step "
            f"at the {where} rate {sector_ms:.4f} ms (share of the kernel's time "
            f"{sector_ms / ms:.4f}"
            + (": the kernel beats it" if ms < sector_ms else "")
            + "; not a bound); equal bit for bit")
        return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by="bytes", library_ms=plain_ms)

    for w, steps in ((W_PROBE, STEPS_PROBE), (W_FRAME, STEPS_FRAME)):
        idx0 = torch.from_numpy(start_rows(N_ROWS, w, seed)).to(dev)
        out(f"walks, W = {w} walkers x {steps} steps, N = {N_ROWS}:")
        for kind, step_bytes, sectors in (("thread-row", 512, 16), ("warp-row", 512, 16),
                                          ("chase", 8, 2), ("lane", 4, 1)):
            plain = lane_plain if kind == "lane" else walk_plain
            res = case(f"{kind} (row {3 if 'row' in kind else 4 if kind == 'chase' else 5})",
                       tab, idx0, steps, step_bytes,
                       lambda k=kind: walk(k, tab, idx0, steps),
                       lambda p=plain: p(tab, idx0, steps),
                       table_bytes_read(kind, tab, idx0, steps), w * 8, sectors)
            if w == W_FRAME:
                results[kind] = res
    out(f"rows-acc (row 6), S = {ROWS_ACC_S} warp walkers x {STEPS_PROBE} steps:")
    for n in ROWS_ACC_N:
        t = torch.from_numpy(make_table(n, seed)).to(dev)
        idx0 = torch.from_numpy(start_rows(n, ROWS_ACC_S, seed)).to(dev)
        results["rows-acc"] = case(
            f"N = {n} ({n * 512} bytes)", t, idx0, STEPS_PROBE, 512,
            lambda: walk("rows-acc", t, idx0, STEPS_PROBE),
            lambda: rows_acc_plain(t, idx0, STEPS_PROBE),
            table_bytes_read("rows-acc", t, idx0, STEPS_PROBE), ROWS_ACC_S * (4 + 512), 16)
    rng = np.random.default_rng(seed + 2)
    img = torch.from_numpy(rng.standard_normal((1080, 1920, 4), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 1080 * 1920, 1080 * 1920).astype(np.int32)).to(dev)
    out("gather16: 2,073,600 random 16-byte rows of a 1920x1080x4 float32 image:")
    results["gather16"] = case("gather16 (img[idx])", img, idx, 1, 16,
                               lambda: gather16(img, idx), lambda: gather16_plain(img, idx),
                               int(torch.unique(idx).numel()) * 16, idx.numel() * 16, 1)
    return results


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

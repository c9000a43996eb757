"""kernels.k2_roofline: the least time one frame's K2 launches could take,
bound by bytes at the H100's 3.35 TB/s, over their measured device time
(``kernels.k2_ms``), in percent.

Bytes a frame, the same whatever implements K2, from the launches' shapes
(the cell's ``k2_wavefronts``: rays a pixel and the hit they want) and the
table's size:

- each ray's inputs read once: origin and direction (24 bytes) and its
  tmax (4);
- each hit written once: an any-hit ray's flag (1 byte), a closest-hit
  ray's distance, triangle and two barycentrics (16);
- the BVH8 table read once a launch: at least one leaf row a leaf_max (8)
  triangles and one internal row a 7 rows below it, at the configuration's
  bytes a row (256 bf16, 512 f32).

The operations a ray's walk must do (a box or a triangle test a visited
slot) need counts from inside the program; they are not priced here."""
import math

from portbench.lib import kernels, peaks

RAY_IN_BYTES = 28
HIT_BYTES = {"any": 1, "closest": 16}
LEAF_MAX = 8


def frame_bytes(config: dict, wavefronts: list, triangles: int) -> float:
    pixels = config["width"] * config["height"]
    leaf_rows = math.ceil(triangles / LEAF_MAX)
    rows = leaf_rows + math.ceil(max(leaf_rows - 1, 0) / 7)
    table = rows * config["bvh_row_bytes"]
    total = 0.0
    for w in wavefronts:
        rays = pixels * w["per_pixel"]
        total += rays * (RAY_IN_BYTES + HIT_BYTES[w["hit"]]) + table
    return total


def read(ctx):
    ops = getattr(ctx, "ops", None)
    wavefronts = ctx.cell.workload.get("k2_wavefronts", [])
    if not ops or not wavefronts:
        return None
    lo, hi = ctx.window_us
    ms = kernels.device_ms(ops, lo, hi, lambda n: kernels.kernel_of(n) == "K2") / ctx.frames
    if ms <= 0:
        return None
    bound_ms = frame_bytes(ctx.config, wavefronts, ctx.triangles) / peaks.HBM_BYTES_PER_S * 1e3
    return 100.0 * bound_ms / ms

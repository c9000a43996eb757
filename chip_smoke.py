#!/usr/bin/env python3
"""Drive the PyTorch port (vulkanhybridrenderer_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # and a torch.profiler window of main paths 2-11
    python3 chip_smoke.py --parent DIR # and K2 (each row kind), K3, K4, the toy and the
                                       # probe's thread-row, warp-row, lane and rows-acc
                                       # walks against DIR's (another checkout's)
                                       # kernels, in turns

Phases, each printed with its seconds; any failure raises and exits non-zero:
  1. device   - the GPU's name, nvidia-smi's name / power limit / max SM clock
                (no CUDA: fail)
  2. build    - nvcc builds csrc/raster_tile.cu (K1a, K1b, K1c, K1d),
                csrc/bvh8_trace.cu (K2, four lanes a ray, with and without
                the alpha filter, for each row kind: f32 rows with 8-triangle
                leaves in place, with 12 or bf16 rows through their
                lane-major copy, traverse.pack_rows), csrc/shadow_grid.cu (K3, the shadow
                grid's trace: a block's live rays queued in shared memory,
                its cells' lists staged there, the big tier first),
                csrc/bvh_flat_trace.cu (K4,
                the threaded walk of a binary BVH, a thread a ray, a wait at
                a leaf of at most six internal steps),
                csrc/toy_scale.cu and csrc/gather_probe.cu for sm_90a and g++
                the host BVH build (native/*.cpp), all at once; ptxas
                registers / spills per kernel.  The toy library is asked for
                again by a subprocess in another working directory: the same
                _build/ file, no second compile; the toy kernel's output
                equals x * 2 exactly (its launch is the toy's path); the toy
                at 256x256 and 4096x4096 (wrapper, kernel alone, x * 2.0,
                torch.mul, bit equality), on an odd length and a misaligned
                view; the launch path the other wrappers take (a Stream
                object inside torch.cuda.device) against the toy's
  2b. asset   - the flagship asset, realglb: scene/sample_asset writes the
                sponza-class GLB into the package's _build/, runtime/app's
                load_any_scene("realglb") reads it (PNG textures through
                utils/png, no PIL); seconds to write, to decode its PNGs, to
                load, and to build the host BVH8 (its rows and depth bound);
                its counts must be the reference writer's (254,636
                triangles, 370 primitives, 39 textures, 600 alpha-masked
                triangles, atlas (4, 72, 2560)); a 1024x1024 RGBA PNG round
                trip must be exact
  2c. jpeg kinds - tests/data/torch_jpeg's eight streams (arithmetic-coded
                sequential with restarts and DAC, and progressive; lossless
                grey, RGB and CMYK; CMYK with and without Adobe APP14;
                YCCK): utils/jpeg.decode_jpeg must equal each beside-file
                Pillow decode exactly (host seconds a stream printed); a
                glTF showing them (sample_asset.build_texture_board_glb)
                loads to the atlas of those decodes and renders its second
                frame of the flagship configuration (full hybrid,
                alpha_raster="brute") at 320x180 on the card, finite
  3. golden   - cornell_box() at 64x64 (shadow_map_size 128) on the GPU against
                the JAX package's goldens (RMSE <= 2e-3 after clamping to
                [0, 1], the reference's golden tolerance): the RT-shadows frame
                (hybrid_rt_shadows_cornell.npy), the full hybrid frame after
                2 frames (hybrid_full_cornell.npy), the forward frame
                (forward_cornell.npy), the raster-mode hybrid frame
                (hybrid_raster_shadows_ssao.npy), the raytraced frame
                (raytraced_cornell.npy) and the rayquery frame on
                checker_quad() (rayquery_checker.npy); and the Atrium
                (build_sample_glb, written and read by the port) forward at
                96x96 against atrium_forward.npy, RMSE <= 2e-3 on the pixels
                without a near depth tie (rasterizer_tiled.depth_ties: the
                floor and the columns' bottom faces z-fight there, decided by
                the last bits of each setup; at most 0.5% of the frame),
                printed with the RMSE over every pixel
  4. kernels  - at the slice's shapes (SponzaProxy, 1920x1080, the full
                configuration's second frame: frame 0's RNG seed is the same
                for every pixel, so its AO rays are coherent and fast)
                bvh8.validate_host on the frame's SAH BVH8 (and on
                realglb's below, with its host seconds), then each kernel
                against its plain PyTorch version on the same inputs:
                every K1 instance below must give depth, tri id and bary
                equal to its plain version on every pixel (both round every
                product separately): K1a on every triangle and on the full
                frame's opaque stream; K1b on the alpha-masked stream, round
                1's bound and the real round-2 bound; K1c on round 2's live
                tiles as the peel lists them (live_tiles: a slot for every
                tile of the image, the live ones first, their count on the
                device; a block a slot), also against K1b's full-width round
                2 and against K1c over the list cut to its live slots (and
                round 2 must have a live tile); K1c's kernel is timed alone
                on both lists, into outputs filled before the timing window,
                and its wrapper (fill + kernel) beside it.  Each K1 bound counts the (entry,
                8x4 sub-tile) pairs that pass the kernels' corner test
                (rt.subtile_masks, priced by rt.raster_ops),
                printed beside the dense bound of every (entry, pixel) pair;
                K2 any-hit on the frame's shadow and AO wavefronts: identical
                hit masks; K2 closest-hit on its reflection wavefront: t, tri,
                u and v equal on every ray.  Then K2's other row kinds on
                the same wavefronts (and on realglb's below): the bf16 rows
                of the frame's SAH table (table_to_bf16) and the f32 rows of
                its SAH tree with 12-triangle leaves, any-hit on the shadow
                and AO rays, closest-hit on the reflection rays, and both
                through the alpha filter (shadow, reflection), each with t,
                tri, u and v equal to its plain version on every ray, its
                bound (the bytes of the table it reads, the packed copy's:
                256 a bf16 row, 512 an f32 one; the operations
                trace_plain(visits=True) counts plus, on bf16 rows, the
                centroid's add to each triangle's 9 coordinates) and its
                time beside the f32 leaf-8 kernel's on the same rays; with
                --parent, DIR's K2 of the same kind (on the reference's
                table: the packed copy is this checkout's) and on the f32
                leaf-8 table, equal outputs and timed in turns with this
                one.  Kernel and plain times by CUDA
                events, each kernel's bound (K2's from the rows and filter
                evaluations trace_plain counts on the same rays, printed per
                wavefront with the bound's share of the kernel's time and the
                share of a warp's ray-steps that visit a row), and the peel's
                tiles / killed pixels per round.  Then on the forward
                configuration's second frame (coverage MSAA 4x): K1d at 2,
                4 and 8 samples on the opaque stream against its plain
                version, and at 4 and 8 against as many K1a launches on
                offset_planes; the same K1a, K1b, K1c and K2 instances on
                realglb's full frame (main path 8's shapes, on its f32
                leaf-8 SAH table; printed, not in the JSON line), and the
                other row kinds on it (the JSON line's entries of those
                kinds); on that frame the device LBVH
                (ops/bvh.build of the Geometry pass's WorldTris): its build
                time by CUDA events, its true depth (<= 64, the build's
                sweeps), the native host LBVH's time, order / left / right /
                escape equal to the native tree's and boxes within 1e-6,
                validate_host; pack_flat's tables (once per tree); K4 on the
                shadow, AO and reflection wavefronts against
                trace_flat_plain (t, tri, u and v equal on every ray),
                unfiltered and filtered, its time (wrapper, kernel alone,
                filtered), the plain version's, K2's on the same rays, the
                bound (26 operations a visited internal node, 59 a tested
                triangle), nodes / triangles a live ray (mean, p99), the
                lane share of 32 rays in pixel order and the kernel's own
                count; with --parent, DIR's K4 in turns with this one; K4
                against K2
                on the SAH BVH8, the oracle (hit flags; closest hits t
                within 1e-4 and the same triangle unless the two t are
                equal) on >= 99.99% of live rays, every disagreement
                printed; K4 over the SAH binary tree against its plain
                version and K2, timed in turns with K2; the LBVH refit for a
                rigid move against
                a fresh build (K4's hit masks equal); and K2 over the
                LBVH's BVH8 (main path 12's tree) against its plain version
                with its rows a live ray; K1a at the shadow map's shape (4096^2, every
                triangle, light clip) against its plain version, with its
                bound and launches.  K1d's time beside the four K1a
                launches it replaces.  Then on the raytraced path's second
                frame (RaytracedSettings(test_alpha=True)): filtered K2
                closest-hit on the primary wavefront against its plain
                version (t, tri, u and v equal on every ray), filtered K2
                any-hit on the shadow wavefront (identical hit masks), and the
                filtered against the unfiltered primary hits (they must
                differ: the filter rejected something).  Then the inputs of
                main paths 7 and 6: K2 on the rt_scale=2 frame's shadow, AO
                and reflection wavefronts (960x540, second frame; the same
                checks), K1a on the rayquery frame's entry stream (every
                triangle, masked ones solid) and K2 any-hit on its shadow
                rays.  Then main path 10's inputs: K3 on the second frame's
                shadow wavefront of cell 1's configuration with
                shadow_accel="grid", and on realglb's in the same
                configuration with a grid built on realglb, each unfiltered
                and filtered (the scene's alpha tables): hit masks identical
                to its plain version's in both orders and to K2 any-hit's on
                every ray, also without the width, with an (R,) tmin and
                with a staging capacity (stage_rows 16, and 0) below the
                longest cell list; tests a live ray (mean, p99) and the bound
                (K3_OPS_STAGE operations a test by the stage at which it
                ends, counted by trace_shadow_plain(visits=True,
                stages=True), or the bytes its walks need) in
                the reference's order and in K3's (the big tier first); the
                lane share of 32 rays in pixel order in both orders and of
                K3's queue (counted by the kernel); the kernel alone's time
                (also at stage_rows 0 and 512), the wrapper's, the
                filtered kernel's, the plain version's and K2 any-hit's
                (unfiltered and filtered), and the (R,) tmin copy the
                earlier wrapper made; the static grid's rows, live rows,
                bytes, num_big and overflow (which must be 0); the blocks
                of K3 an SM holds at stage_rows 0, 128 and 512 (num_big is
                read on the device, so a block reserves BIG_CAP big rows)
  5. gpu-cpu  - SponzaProxy at 320x180 on the GPU and on the CPU (plain
                versions): the RT-shadows frame within 1e-4 on >= 99.9% of
                pixels; the full configuration over 3 frames within
                GPU_CPU_FULL_TOL on >= GPU_CPU_FULL_SHARE of pixels per frame;
                the forward coverage-MSAA 4x frame (alpha_raster="brute") and
                the raster-mode hybrid frame with SSR over 3 frames within
                GPU_CPU_RASTER_TOL on >= GPU_CPU_RASTER_SHARE (shadow_map_size
                512: the CPU's plain raster of a 4096^2 map takes minutes);
                the raytraced frame with test_alpha (the RT-shadows gate),
                the rayquery frame, the full frame at rt_scale=2 and
                realglb's full frame over 3 frames (the full frame's gate);
                main path 9's brute frame on cornell_box() (the raster
                gate), path 10's grid frame (the RT-shadows gate) and path
                11's animated frame over 3 animated frames (the full
                frame's gate), path 12's (realglb by the renderer's
                no-native route: both renderers built with the port's
                native_available() returning False, each BVH8 the LBVH of
                its own device collapsed in Python, the two equal; the
                full frame's gate) and path 8's on realglb's bf16 atlas
                over 2 frames (the full frame's gate).  The stages of the forward
                frame: clip-space vertices and triangle setups must agree on
                every value
  6. main     - native_available() must be True (paths 1-11 are the SAH
                tree's; no silent fallback to the LBVH's), then
                thirteen paths at 1920x1080, SponzaProxy but paths 8, 9,
                11, 12 and 14, each driven with the
                launch counters set to 0 just before its 10 timed frames (after
                2 warm-up frames: with the default dispatch="fused" the
                first runs eagerly and the second captures the frame, so
                the 10 replay CUDA graphs) and read just after; every kernel
                of the slice must rise by >= 1 per frame; finite output;
                per-pass ms; each path then runs phase 6d below:
                  the RT-shadows frame (HybridSettings(), alpha off): K1a, K2;
                  the full frame (RT shadows + RT AO + RT reflections + SVGF,
                  alpha_raster="brute", 4 peel rounds, temporal state carried):
                  K1a, K1b, K1c, K2 any-hit and closest-hit; live rays per
                  wavefront and a breakdown of the frame by CUDA events;
                  the forward frame, coverage MSAA 4x (alpha_raster="brute",
                  4 peel rounds, the 4096^2 shadow-map prepass): K1a, K1b,
                  K1c, K1d;
                  the raster-mode hybrid (rasterized shadows + SSAO, alpha
                  off): K1a twice a frame (G-buffer and prepass, counted
                  apart by the image each rasters in 10 more eager frames:
                  10 each); and one time_passes of it with SSR on;
                  5. the raytraced frame with test_alpha: filtered K2
                  closest-hit and any-hit;
                  6. the rayquery frame: K1a, K2 any-hit;
                  7. the full frame at rt_scale=2: K2 any-hit and
                  closest-hit, its ms/frame beside path 2's;
                  8. bench.py's flagship as written: the full frame on
                  realglb (254,636 triangles) with the default
                  RenderConfig table knobs (bvh_dtype="auto",
                  bvh_leaf_max=0), which must pick bf16 rows (the f32 and
                  bf16 table bytes printed): K1a, K1b, K1c, K2 bf16-8
                  any-hit and closest-hit, its breakdown, its ms/frame
                  beside path 2's; then the same on realglb loaded with
                  atlas_dtype=torch.bfloat16 (its atlas bytes against the
                  f32 atlas's, printed in phase 2b with its load seconds;
                  its ms/frame beside path 8's);
                  9. path 4's configuration with raster="brute" on
                  cornell_box() (the 4096^2 brute prepass included): no hand
                  kernel launches; its visibility against the binned raster
                  of the same frame (tri id or depth differ on <= 0.2% of
                  pixels) and a less_equal / clear 1.0 raster nearer
                  wherever both cover; the brute raster's and prepass's ms;
                  10. path 1's configuration with shadow_accel="grid": K1a
                  and K3, no K2 and no BVH resource; its frame equal to
                  path 1's from the same renderer state (torch.equal);
                  11. pica_proxy() animated (animate_pica before every
                  frame), the full configuration with shadow_accel="grid":
                  K1a, K2 any-hit and closest-hit, K3, BVH Refit and Shadow
                  Grid Build every frame, consecutive frames differ; on
                  frame 5, the rebuilt grid's bytes, K3 timed (and with
                  --parent in turns with DIR's) and checked as on path 10's
                  rays, K3's mask equals K2 any-hit on the refit BVH8
                  and on a fresh host build, closest hits agree (t within
                  1e-4, the triangle but on equal-t ties), and the refit
                  rows equal refit8 run again on the card and the CPU;
                  validate_host on the BVH Refit pass's output after the
                  last frame;
                  12. path 8's frame by the renderer's own route without
                  a native build (the reference's _get_bvh): the renderer
                  built with native_available() returning False and the
                  native library refused, its BVH8 the device LBVH
                  collapsed in Python and, by the default table rule,
                  re-encoded in bf16 (its kind printed), equal (rows, refit
                  metadata, depth) to the native collapse of the same LBVH
                  re-encoded alike; host seconds of the route, the native
                  and the Python collapse; validate_host on both f32
                  collapses; then K1a, K1b, K1c, K2 any-hit and closest-hit
                  of the route's kind, its ms/frame beside path 8's, K2's rows a
                  live ray on the two trees, a 3-frame profile (device
                  ms/frame, busy share); then K4's path: the frame's three
                  wavefronts through trace(pack_flat(LBVH, WorldTris)) with
                  the counters set to 0 just before, hit flags against K2
                  over the LBVH's BVH8; the reference's positional
                  trace(bvh, tri_verts, o, d, tmin, tmax) on the binary
                  LBVH and on its BVH8, equal to the keyword form, and
                  graph.time_passes(res, iters=2);
                  14. the table kinds path 8 does not trace, on realglb:
                  the full frame with bvh_leaf_max=12 (K2 f32-12 any-hit
                  and closest-hit), the raytraced frame with test_alpha on
                  the default table (K2 bf16-8 filtered any-hit and
                  closest-hit) and with bvh_leaf_max=12 (K2 f32-12
                  filtered); each must trace its kind
  6d. dispatch - on each of those paths, at its configuration, on the BVH8,
                shade tables and shadow grid of the path's renderer: one
                eager frame with every pass under
                torch.cuda.set_sync_debug_mode("error"), where no pass may
                sync; a dispatch="fused", a "per_pass" (precompile_passes
                first) and
                an eager (graph.run) renderer in lockstep over 4 frames, the
                temporal state carried, frames bit-equal; the graphs a frame
                (fused 1, per_pass one a pass, else the run fails) and the
                capture seconds of both modes; on paths 9 and 11 the device
                ms of the brute G-Buffer Pass and Depth Prepass, and of the
                Shadow Grid Build and Raytrace Pass, each pass's per_pass
                graph replayed alone; ms/frame of fused and per_pass in
                turns (fused, per_pass, per_pass, fused; 10 frames each)
                beside 10 eager frames; launches per 10 frames, where the
                counts a captured frame adds at each replay (those of its
                capture) must equal the eager frames', which the wrappers
                count, and drive()'s on the path (the JSON line's);
                on paths 2, 8, 9 and 11 a torch.profiler window of 5 frames
                of each (device busy share).  After path 4: the viewer's
                ssao_radius slider over 8 values (a config and a per_pass
                capture each) must leave torch.cuda.memory_reserved where
                the second value left it.  After path 9: cornell_box() with the
                entry cap patched to 64 must raise check_binning's error at
                its first frame and give a NaN-poisoned next frame, whose
                first non-finite pass is the G-Buffer Pass
  6b. surface - realglb's full frame at 320x180: list_resources is the set
                of the graph's outputs, debug_dump's PNG decodes to
                to_uint8_image, find_nonfinite_pass() is None, stats.table()
                printed, profile() writes a Chrome trace under _build/
  6c. mesh    - main path 8 and cell 4's raster mode (path 4's
                configuration) on realglb at 1080p over a mesh
                (parallel/mesh.py, the frame row-sharded: every image pass
                a shard over its slab, with halo and gather exchanges):
                make_mesh() where the machine has two cards or more, else a
                virtual mesh of 4 shards on the one card (printed: real or
                virtual).  The sort-last raster of realglb's 1080p frame
                (1080 rows / 4 bands) equal to rasterize_scene on every
                pixel, K1a launched once per shard; frames 1 and 2 of
                Renderer(mesh=) equal (torch.equal) to the single-device
                renderer's for both configurations (path 8 on its bf16
                table; its kind printed), and frame 1 of the raster mode
                with SSR too; K1a once per shard and frame, K2 once per
                slab and wavefront; for each configuration a whole mesh
                frame under set_sync_debug_mode("error") (no synchronizing
                call), the bytes a frame moves between shards by kind
                (halos, gathers, the raster's bands, replicas, the output),
                each pass's device ms on each shard (CUDA events on the
                shard's stream, parallel/mesh.ShardClock) beside one
                card's time_passes, and ms/frame of both renderers in turns
                (single, mesh, mesh, single; CUDA events on the primary's
                stream, which waits for every device of the mesh) with
                nvidia-smi's line; K1a on shard 0's triangles and K2 on
                slab 0's AO and reflection rays against their plain
                versions, timed, with their bounds (the JSON line's mesh
                entries, their launches path 8's timed mesh frames').  Since
                the mesh frame is captured (runtime/dispatch.py: one CUDA
                graph a frame, or a pass, spanning the mesh's cards): path
                8, cell 4 with and without SSR, the full frame at
                rt_scale=2 and path 11 (the animated pica), fused and
                per_pass (precompile_passes), equal (torch.equal) to the
                eager mesh frame and one card's over frames 0-3 with the
                camera moving; the warm-up and the captures under
                set_sync_debug_mode("error"); a replayed frame's launches
                and Mesh.moved bytes equal to the eager frame's; graphs a
                frame and capture seconds; ms/frame in turns (one card
                fused, mesh eager, mesh captured) but for SSR's.  Then
                the other paths, row-sharded as the hybrid (each shard
                rasters its band, traces and shades its slab): the
                raytraced frame with test_alpha (cell 14's, bf16 rows),
                the rayquery frame (cell 6's configuration) and the
                forward frame at one sample and at supersample 4 (a
                3840x2160 raster), on realglb: the same captured checks
                over frames 0-3, no halo and no gather moved, every eager
                frame launching K1a once per shard and image rastered and
                K2 once per slab and wavefront, Mesh.moved by kind, each
                pass's device ms on each shard (ShardClock), ms/frame in
                turns (one card fused, mesh captured, mesh captured, one
                card fused); then K2 filtered closest-hit and any-hit on
                the raytraced frame's slab-0 primary and shadow rays, K2
                any-hit on the rayquery frame's slab-0 shadow rays and K1a
                on shard 0 of the supersample raster against their plain
                versions, timed, with their bounds (the JSON line's
                "raytraced mesh slab", "rayquery mesh slab" and
                "supersample mesh shard" entries, their launches the first
                captured turn's 10 frames').  Any failure fails the run
  7. probe    - the row-gather probe (probes/gather.py), printed in full:
                the yardstick (the delivered L1 and L2 read rates in TB/s
                and bytes a clock an SM, their bit sums equal to a plain
                sum; one warp's dependent-load latency in L1 and in L2; the
                rows the frame-width walkers share, step by step), then
                every probe kernel against its plain version bit for bit,
                each with its bound (bytes or float32 adds) and share and
                the walks' L1 ceiling (gathered bytes at the delivered L1
                rate) and share, row-loop (row 4) beside its modelled
                ceiling (a line lookup a clock an SM); lane (row 5) also
                with 0 steps (its transposes and staging alone) and on a
                table whose values reach +-1e5 (the modulo's `%` path);
                thread-row and warp-row against walk_guarded on a table
                whose ids leave it and whose rows hold +inf, row-loop and
                lane from start ids outside the table; rows-acc (row 6)
                at N = 256, 2,048, 20,480 beside each walker's distinct
                rows, its latency floor (all walkers on one SM: rows no
                other walker reads at L2, the rest at L1; at N = 256 the
                lesser of that and one bulk copy plus shared-memory loads),
                each walker on an SM of its own and the union floor (every
                step at the level that holds all its rows), with shares as
                a launch and in a CUDA graph, and on a table whose ids
                leave it (the TPU op's mod N) bit for bit on both routes
                (N = 256 staged, 2,048 global); the yardstick also times
                the shared-memory ring, rows-acc's step ring, the L1 ring
                at 64-256 KB (the L1 global loads get) and one block's
                bulk copy of the N = 256 table; with --parent, DIR's
                thread-row, warp-row and lane checked and timed in turns
                with this checkout's at both widths, and DIR's rows-acc at
                each N in turns in CUDA graphs; the launch counts of its
                run.  Phase 2 also counts the global loads in row-loop's
                machine code (cuobjdump -sass): every one of a walker's
                unrolled loads is there; and in rows-acc's fast step loop
                (both routes) no shuffle, and no read of a row's registers
                before the chain's next wait for an id loaded earlier than
                that row (_rows_acc_sass)
Then one JSON line with the kernels, nvidia-smi's line, and the status line.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WIDTH, HEIGHT = 1920, 1080
REPO = Path(__file__).resolve().parent
GOLDENS = REPO / "tests" / "goldens"
#: streams of every JPEG kind beyond Huffman DCT, each beside Pillow's decode
#: (.npy), written by tests/jpeg_writers.py and checked current by
#: tests/test_torch_jpeg_kinds.py
JPEG_FIXTURES = REPO / "tests" / "data" / "torch_jpeg"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
FP32_LANES_PER_SM = 128  # Hopper: one non-FMA FP32 instruction per lane per clock
# K1's FP32 operations (per tested (entry, pixel) pair, and the corner
# test's per entry and per (entry, sub-tile)) are counted from
# csrc/raster_tile.cu in ops/rasterizer_tiled.py, which prices them with
# raster_ops.
#: K2's FP32 operations per slot of a row it visits, counted from
#: csrc/bvh8_trace.cu (--fmad=false).  A box (an internal row's non-empty
#: slot), 26: 6 FADD + 6 FMUL of the slab planes, 10 min / max of tnear and
#: tfar, the interval's 2 min / max, 2 compares.  A triangle (a leaf row's
#: slot with tri >= 0), 59: 6 FADD of the edges, p 9 (6 FMUL + 3 FADD), det
#: 5, 1/det 3 (compare, select, division), tv 3, u 6, q 9, v 6, t 6, the
#: acceptance tests 6 (5 compares, 1 FADD).  An empty slot of either kind,
#: 1: the compare that rejects it (lo.x <= hi.x, tri >= 0).  One alpha
#: filter evaluation (alpha_accept), 53: 1 + 2 + 5 + 5 compares and
#: products of the uv, 8 + 2 + 2 + 2 of the texel address, 10 of the two
#: remainders, 2 + 2 of the offsets and weights, 11 of the bilinear alpha,
#: 1 compare.  trace_plain(visits=True) counts the rows, slots and
#: evaluations of each run.
K2_OPS_BOX, K2_OPS_TRI, K2_OPS_EMPTY, K2_OPS_FILTER = 26, 59, 1, 53
#: K2's row kinds, in the order of csrc/bvh8_trace.cu's kKind (ops/traverse.KERNEL_KINDS)
K2_KINDS = ("f32-8", "f32-12", "bf16-8")
#: the bf16 decode's FP32 operations a triangle (a non-empty slot of a
#: visited leaf row) on the packed copy K2 reads (ops/traverse.pack_rows):
#: its centroid c_hi + c_lo added to its 9 coordinates, as
#: ops/traverse.decode_rows adds it.  The packing decodes the child base,
#: offset map, triangle ids and the centroid's sum once per table; an
#: internal row's planes need no operation (a bf16's f32 value is its bits
#: shifted up, an integer operation).
K2_OPS_DECODE_TRI = 9
#: K3's FP32 operations per test, by the test at which its early-returning
#: Moller-Trumbore (csrc/shadow_grid.cu row_hit) ends, from K2's 59: at det
#: 21 (the edges 6, p 9, det 5, its compare 1), at u 33 (+ 1/det 1, tv 3,
#: u 6, two compares 2), at v 51 (+ q 9, v 6, u + v 1, two compares 2), in
#: full 59 (+ t 6, two compares 2).  trace_shadow_plain(stages=True) counts
#: the tests that end at each.
K3_OPS_STAGE = (21, 33, 51, 59)
#: the full frame on the GPU against the CPU: measured >= 0.999792 of pixels
#: within 1e-3 by frame 2 (NVIDIA H100 80GB HBM3, 700 W).  A grazing AO ray
#: flips between the two devices' sin / cos, and SVGF spreads the flip.
GPU_CPU_FULL_TOL, GPU_CPU_FULL_SHARE = 1e-3, 0.999
#: the forward coverage-MSAA frame, the raster-mode hybrid with SSR and the
#: rayquery frame on the GPU against the CPU: the full frame's gate.  Measured
#: (NVIDIA H100 80GB HBM3, 700 W) since the port divides by a 0-dim tensor on
#: the tensor's device (math3d.div) wherever it divided by a Python scalar,
#: which CUDA turns into a product with the reciprocal: triangle setups equal
#: on every triangle (0.487 before), the forward frame within 1e-5 on every
#: pixel (0.999514 within 1e-3 before), the raster-mode frame within 1e-4 on
#: 0.999965 (max 2.7e-4), the rayquery frame equal.  Phase 5 prints the stages.
GPU_CPU_RASTER_TOL, GPU_CPU_RASTER_SHARE = 1e-3, 0.999


def _k2_name(kind: str, mode: str) -> str:
    """K2's name in the JSON line and the launch counters: "K2 <mode>" on an
    f32 leaf-8 table, "K2 <kind> <mode>" on the other kinds."""
    return f"K2 {mode}" if kind == "f32-8" else f"K2 {kind} {mode}"


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _max_abs(d) -> float:
    return float(d.abs().max()) if d.numel() else 0.0


def _cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() over `iters` runs, by CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _full_settings(config):
    return config.HybridSettings(
        shadow_mode=config.ShadowMode.RAYTRACED,
        ao_mode=config.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=config.ReflectionMode.RAYTRACED, denoise=True, rt_scale=1,
    )


def _ptxas_report(log: str, names: dict[str, str]) -> list[str]:
    """ptxas -v lines (registers, spills) per kernel entry of an nvcc log;
    names maps a substring of the mangled entry name to a kernel name."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = next((v for k, v in names.items() if k in m.group(1)), m.group(1))
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"  ptxas {entry}: {line.strip()}")
    return out


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}
_C_INTS = (ctypes.c_int, ctypes.c_longlong)


def _c_params(source: Path, symbol: str) -> list:
    """[(name, ctypes type)] of the launch function `symbol`, read from its
    prototype in the CUDA source `source`."""
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", source.read_text())
    _check(m is not None, f"{source} has no launch function {symbol}")
    params = []
    for decl in m.group(1).split(","):
        decl = " ".join(decl.split())
        name = re.search(r"(\w+)$", decl).group(1)
        base = decl[:-len(name)].replace("const ", "").strip()
        _check(base.endswith("*") or base in _C_TYPES, f"{symbol}: a parameter {decl!r}")
        params.append((name, ctypes.c_void_p if base.endswith("*") else _C_TYPES[base]))
    return params


def _sass_functions(build, source: str) -> dict[str, str]:
    """cuobjdump -sass of csrc/<source>'s built library: {mangled name:
    its instructions' text}."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.cuda_library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    return {part.split(None, 1)[0]: part for part in sass.split("Function : ")[1:]}


def _row_loop_sass(build) -> str:
    """The global loads (LDG) in row-loop's machine code, read by cuobjdump
    from the built probe library; fails unless one stretch between two
    branches (the unrolled step loop) holds all kRowLoopUnroll loads of
    row[0]: a compiler that merged loads of one address would leave one."""
    src = (build.CSRC_DIR / "gather_probe.cu").read_text()
    unroll = int(re.search(r"kRowLoopUnroll = (\d+)", src).group(1))
    body = next((part for name, part in _sass_functions(build, "gather_probe.cu").items()
                 if "walk_row_loop" in name), None)
    _check(body is not None, "cuobjdump shows no walk_row_loop")
    loads, stretches, run = [], [], 0
    for line in body.splitlines():
        m = re.search(r"\b(LDG(?:\.[\w.]+)?)\s", line)
        if m:
            loads.append(m.group(1))
            run += 1
        elif re.search(r"\bBRA\b", line):
            stretches.append(run)
            run = 0
    most = max(stretches + [run])
    _check(most >= unroll, f"row-loop's machine code holds at most {most} global loads between "
           f"two branches, fewer than its {unroll} unrolled loads of row[0]")
    return (f"row-loop SASS (cuobjdump): {len(loads)} global loads in walk_row_loop "
            f"({', '.join(sorted(set(loads)))}), {most} of them in the unrolled step loop "
            f"between two branches ({unroll} steps), the rest the id's and the remainder loop's")


def _sass_ops(body: str) -> list[tuple]:
    """(address or label, opcode, operands, predicated) of each instruction
    (and (label, None, None, False) of each label) in one function's SASS."""
    ops = []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            ops.append((lab.group(1), None, None, False))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)\s*([^;]*);", line)
        if m:
            ops.append((int(m.group(1), 16), m.group(3), m.group(4), m.group(2) is not None))
    return ops


def _regs(text: str, op: str = "") -> set[int]:
    """The general registers an operand list names (Rn.64 is Rn, Rn+1); with
    `op`, the registers a destination Rn of that instruction writes (four
    for a .128 load, two for a .64 load or an IMAD.WIDE)."""
    wide = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    out = set()
    for m in re.finditer(r"\bR(\d+)(\.64)?", text):
        out.update(range(int(m.group(1)), int(m.group(1)) + (2 if m.group(2) else wide)))
    return out


def _rows_acc_loop(route: str, load: str, body: list) -> int:
    """One step loop of rows-acc's SASS (_sass_ops, from the branch's target
    to the branch): as many 16-byte row loads as 4-byte id loads (row +
    0xc0, row[48]), no shuffle, and no wait for a row on the id's chain:
    an instruction that reads a row's registers stalls until that row's
    load returns, so the next use of an id after it (the chain's next wait,
    in loop order) must be of an id loaded after that row (loads return in
    the order they issued, so the chain waits no longer than it would for
    that id).  ptxas may issue a row's load steps after its id's.  Returns
    the loop's steps; fails otherwise."""
    n = len(body)
    loop = body + body  # a second lap: the loop's order wraps
    rows, ids = [], {}
    for i, (_, op, args, _) in enumerate(body):
        if op and op.startswith(load):
            dst = int(re.match(r"\s*R(\d+)", args).group(1))
            if ".128" in op:
                rows.append((i, set(range(dst, dst + 4))))
            elif "+0xc0]" in args:
                ids[i] = dst
    shuffles = sum(1 for _, op, _, _ in body if op and op.startswith("SHFL"))
    _check(len(rows) == len(ids) and ids and shuffles == 0,
           f"rows-acc ({route}): a loop holds {len(rows)} row loads, {len(ids)} id loads "
           f"(row + 0xc0) and {shuffles} shuffles")

    def id_use(i: int):
        """(position, id load's position) of the first wait for an id at or
        after position i, in the two laps: the first read of an id load's
        register (later reads find it there)."""
        live = {}  # register -> the id load that wrote it, not yet read
        for j in range(i - n, i):  # the lap before i, for ids loaded earlier
            _, op, args, _ = loop[j % n + n] if j < 0 else loop[j]
            if op:
                dst, _, srcs = args.partition(",")
                live = {r: at for r, at in live.items()
                        if r not in _regs(srcs) and r not in _regs(dst, op)}
                if j % n in ids:
                    live[ids[j % n]] = j
        for j in range(i, 2 * n):
            _, op, args, _ = loop[j]
            if op is None:
                continue
            dst, _, srcs = args.partition(",")
            hit = [live[r] for r in _regs(srcs) if r in live]
            if hit:
                return j, max(hit)
            live = {r: at for r, at in live.items() if r not in _regs(dst, op)}
            if j % n in ids:
                live[ids[j % n]] = j
        return None, None

    for k, (i_row, regs) in enumerate(rows):
        live = set(regs)
        for j in range(i_row + 1, i_row + n):
            _, op, args, _ = loop[j]
            if op is None or not live:
                continue
            dst, _, srcs = args.partition(",")
            if _regs(srcs) & live:
                use, loaded = id_use(j)
                _check(use is not None and loaded > i_row,
                       f"rows-acc ({route}): {op} {args.strip()} waits for step {k}'s row before "
                       f"the chain's next id use, of an id loaded before that row")
            if not op.startswith(("ST", "BRA", "RED", "ATOM")):
                live -= _regs(dst, op)
    return len(ids)


def _rows_acc_sass(build) -> str:
    """rows-acc's fast walk in its machine code (cuobjdump -sass), both
    routes: of the loops (conditional backward branches) around the row's
    16-byte loads without an F2I (the rule's re-walk has one), the one
    that holds the most steps (ptxas unrolls the step loop and leaves a
    remainder loop of a few steps beside it) passes _rows_acc_loop: the
    id's chain never waits for a row.  Fails otherwise."""
    lines = []
    for mangled, body in _sass_functions(build, "gather_probe.cu").items():
        if "walk_rows_acc" not in mangled:
            continue
        route = "staged" if "ILb1E" in mangled else "global"
        load = "LDS" if route == "staged" else "LDG"
        ops = _sass_ops(body)
        where = {key: i for i, (key, _, _, _) in enumerate(ops)}
        loops = []
        for i, (_, op, args, predicated) in enumerate(ops):
            t = re.search(r"0x([0-9a-f]+)|(\.L_x_\d+)", args or "")
            start = where.get(int(t.group(1), 16) if t.group(1) else t.group(2)) if t else None
            ops_in = [o for _, o, _, _ in ops[start:i]] if start is not None and start < i else []
            if (op == "BRA" and predicated and any(o and o.startswith(load) and ".128" in o
                                                   for o in ops_in)
                    and not any(o and o.startswith("F2I") for o in ops_in)):
                loops.append(ops[start:i + 1])
        _check(bool(loops), f"rows-acc ({route}): no loop around a 16-byte {load}")
        main = max(loops, key=lambda lp: sum(1 for _, o, a, _ in lp
                                             if o and o.startswith(load) and "+0xc0]" in a))
        steps = _rows_acc_loop(route, load, main)
        lines.append(f"rows-acc SASS ({route}, cuobjdump): the fast walk's step loop, "
                     f"{len(main)} instructions, holds {steps} steps (beside "
                     f"{len(loops) - 1} remainder loop(s)), each a 16-byte {load} of the row and "
                     f"a 4-byte {load} of row[48]; no shuffle; every read of a row precedes "
                     f"only uses of ids loaded after that row")
    _check(len(lines) == 2, f"cuobjdump shows {len(lines)} walk_rows_acc instances, not 2")
    return "\n".join(lines)


def _other_launch(csrc: Path, source: str, symbol: str):
    """(launch function, its parameters) of another checkout's
    csrc/<source>, built beside this checkout's from that csrc/'s source
    and headers, its prototype read from the source; None where the source
    and headers are this checkout's own (nothing to compare)."""
    from vulkanhybridrenderer_tpu_torch.utils import build

    mine = [build.CSRC_DIR / source] + sorted(build.CSRC_DIR.glob("*.cuh"))
    theirs = [csrc / source] + sorted(csrc.glob("*.cuh"))
    if [p.name for p in mine] == [p.name for p in theirs] and all(
            a.read_bytes() == b.read_bytes() for a, b in zip(mine, theirs)):
        print(f"--parent: {source} is this checkout's own: not compared")
        return None
    params = _c_params(csrc / source, symbol)
    lib = build.build_library(f"other_{Path(source).stem}", [build.nvcc_path()] + build.NVCC_FLAGS,
                              [csrc / source], headers=sorted(csrc.glob("*.cuh")))
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [t for _, t in params]
    return fn, params


def _bind(params, own_params, own_args, extra=None) -> list:
    """Another launch function's arguments, by name: this checkout's value of
    the same name and kind (own_params beside own_args), else `extra`'s
    (name -> a value) for a parameter only the other takes, or takes as
    another kind (a count by value where this one reads it on the device).
    A name neither gives fails the run."""
    own = {name: (t, a) for (name, t), a in zip(own_params, own_args)}
    out = []
    for name, t in params:
        mine = own.get(name)
        if mine is not None and (mine[0] is t or (mine[0] in _C_INTS and t in _C_INTS)):
            out.append(mine[1])
        else:
            _check(name in (extra or {}),
                   f"no value for the other launch function's argument {name}")
            out.append(extra[name])
    return out


def _k2_parent(other, b, label, o, d, tmin, tmax, anyhit, tables, packed=True) -> str:
    """K2 on the BVH8 b (any kind) against another checkout's K2 of the same
    kind (its launch function bound by its prototype's parameter names,
    given the table its own sources walk: traverse.kernel_table(b) where
    they have the packed kernel (`packed`), else b's reference rows; this
    checkout's launch gets traverse.kernel_table(b)): equal outputs on
    every ray, and the two kernels alone timed in turns."""
    from vulkanhybridrenderer_tpu_torch.ops import traverse
    from vulkanhybridrenderer_tpu_torch.utils import build

    fn, _ = traverse.load_kernel()
    n, dev = o.shape[0], o.device
    tmin_a = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(n).contiguous()

    def outs():
        return [torch.empty(n, dtype=t, device=dev)
                for t in (torch.float32, torch.int32, torch.float32, torch.float32)]

    mine_out, other_out = outs(), outs()
    head = [o.data_ptr(), d.data_ptr(), tmin_a.data_ptr(), tmax.data_ptr(),
            n, traverse.default_max_steps(b), int(anyhit), b.depth, traverse.KERNEL_KINDS[b.kind],
            *traverse._table_args(tables)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = ([traverse.kernel_table(b).data_ptr()] + head + [x.data_ptr() for x in mine_out]
            + [stream])
    own_params = _c_params(build.CSRC_DIR / "bvh8_trace.cu", "bvh8_trace_launch")
    pfn, pparams = other
    pargs = _bind(pparams, own_params,
                  [(traverse.kernel_table(b) if packed else b.rows).data_ptr()] + head
                  + [x.data_ptr() for x in other_out] + [stream])
    _check(fn(*args) == 0 and pfn(*pargs) == 0, "a K2 launch against the other checkout failed")
    same = all(torch.equal(a, c) for a, c in zip(mine_out, other_out))
    _check(same, f"K2 {b.kind} differs from the other checkout's on the {label} rays")
    return _in_turns(f"K2 {b.kind} ({'filtered ' * (tables is not None)}"
                     f"{'any-hit' if anyhit else 'closest-hit'}), {label} rays: the other "
                     f"checkout's kernel alone against this one's, outputs equal",
                     lambda: pfn(*pargs), lambda: fn(*args), 10)


def _in_turns(label: str, other, mine, iters: int) -> str:
    from vulkanhybridrenderer_tpu_torch.probes.gather import turns

    t = turns(other, mine, iters)
    return f"{label} in turns (other, this, this, other): {t[0]:.4f} / {t[3]:.4f} ms against " \
           f"{t[1]:.4f} / {t[2]:.4f} ms"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke test needs a CUDA GPU", file=sys.stderr)
        return 1
    argv = sys.argv[1:]
    profile = "--profile" in argv
    other_csrc = (Path(argv[argv.index("--parent") + 1]) / "vulkanhybridrenderer_tpu_torch"
                  / "csrc" if "--parent" in argv else None)

    from vulkanhybridrenderer_tpu_torch import native_bridge
    from vulkanhybridrenderer_tpu_torch.core import config as cfgmod
    from vulkanhybridrenderer_tpu_torch.core.config import RenderConfig
    from vulkanhybridrenderer_tpu_torch.models import hybrid as hybrid_path
    from vulkanhybridrenderer_tpu_torch.models import rayquery as rayquery_path
    from vulkanhybridrenderer_tpu_torch.models import raytraced as raytraced_path
    from vulkanhybridrenderer_tpu_torch.ops import raygen, rasterizer_tiled as rt, rt_shade
    from vulkanhybridrenderer_tpu_torch.ops import rasterizer, shade, shadowgrid, shadowmap, traverse
    from vulkanhybridrenderer_tpu_torch.ops.rasterizer import triangle_setup
    from vulkanhybridrenderer_tpu_torch.ops import bvh as bvh_ops, bvh8 as bvh8_ops, geometry
    from vulkanhybridrenderer_tpu_torch.probes import gather as probe
    from vulkanhybridrenderer_tpu_torch.runtime import app
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu_torch.scene import gltf, procedural, sample_asset
    from vulkanhybridrenderer_tpu_torch.scene.atlas import build_atlas
    from vulkanhybridrenderer_tpu_torch.utils import build, png
    from vulkanhybridrenderer_tpu_torch.utils.jpeg import decode_jpeg
    from vulkanhybridrenderer_tpu_torch.utils.build import build_log
    from vulkanhybridrenderer_tpu_torch.utils.image import to_uint8_image

    full = _full_settings(cfgmod)

    # ---- 1. device -------------------------------------------------------------
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = _smi("name,power.limit")
    sm_clock_mhz = float(_smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fp32_per_s = n_sm * FP32_LANES_PER_SM * sm_clock_mhz * 1e6
    print(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()} | {n_sm} SMs, max SM clock "
          f"{sm_clock_mhz:.0f} MHz -> {fp32_per_s / 1e12:.2f} T FP32 instructions/s")
    print(f"nvidia-smi: {smi}")
    _phase("device", t0)

    def bound(ops: float, nbytes: float):
        """(ms, what sets it): the larger of ops at the FP32 issue rate and
        bytes at the HBM rate."""
        t_ops, t_bytes = ops / fp32_per_s, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    # ---- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    loaders = (rt.load_kernel, traverse.load_kernel, traverse.load_flat_kernel,
               shadowgrid.load_kernel, native_bridge.load, build.load_toy_kernel, probe.load_kernel)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for f in [pool.submit(fn) for fn in loaders]:
            f.result()
    compiles = build.build_library.compiles
    other_k2 = other_k3 = other_toy = other_k4 = other_probe = None
    if other_csrc is not None:
        other_k2 = _other_launch(other_csrc, "bvh8_trace.cu", "bvh8_trace_launch")
        k2_packed = "bvh8_trace_packed" in (other_csrc / "bvh8_trace.cu").read_text()
        other_k3 = _other_launch(other_csrc, "shadow_grid.cu", "shadow_grid_trace_launch")
        other_toy = _other_launch(other_csrc, "toy_scale.cu", "toy_scale_launch")
        other_k4 = _other_launch(other_csrc, "bvh_flat_trace.cu", "bvh_flat_trace_launch")
        other_probe = _other_launch(other_csrc, "gather_probe.cu", "probe_walk_launch")
        compiles = build.build_library.compiles
    for line in (_ptxas_report(build_log("raster_tile.cu"),
                               {"ILb0ELb0E": "K1a", "ILb1ELb0E": "K1b", "ILb1ELb1E": "K1c",
                                "msaa_kernelILi2E": "K1d 2 samples",
                                "msaa_kernelILi4E": "K1d 4 and 8 samples"})
                 + _ptxas_report(build_log("bvh8_trace.cu"), {
                     (f"bvh8_trace_kernelILb{a}ELb{f}E" if k == 0
                      else f"bvh8_trace_packedILi{k}ELb{a}ELb{f}E"):
                     _k2_name(kind, f"{'filtered ' * f}{'any-hit' if a else 'closest-hit'}")
                     for k, kind in enumerate(K2_KINDS) for f in (0, 1) for a in (0, 1)})
                 + _ptxas_report(build_log("bvh_flat_trace.cu"), {
                     f"ILb{a}ELb{f}ELb{c}E": f"K4 {'filtered ' * f}"
                     f"{'any-hit' if a else 'closest-hit'}{', counted' * c}"
                     for c in (0, 1) for f in (0, 1) for a in (0, 1)})
                 + _ptxas_report(build_log("shadow_grid.cu"),
                                 {"trace_kernelILb0E": "K3", "trace_kernelILb1E": "K3 filtered"})
                 + _ptxas_report(build_log("toy_scale.cu"), {"toy_scale": "toy"})
                 + _ptxas_report(build_log("gather_probe.cu"),
                                 {"walk_rows_accILb0E": "walk_rows_acc (global)",
                                  "walk_rows_accILb1E": "walk_rows_acc (staged)",
                                  **{k: k for k in ("walk_thread_row", "walk_warp_row",
                                                    "walk_chase", "walk_lane", "walk_row_loop",
                                                    "gather16", "read_rate", "chase_ring",
                                                    "stage_copy")}})):
        print(line)
    print(f"build: {compiles} compiler runs")
    print(_row_loop_sass(build))
    print(_rows_acc_sass(build))

    # the toy library once more, from another working directory and process:
    # the same file, no compiler run
    toy_lib = build.cuda_library_path("toy_scale.cu")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + ([env["PYTHONPATH"]]
                                                       if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-c", "from vulkanhybridrenderer_tpu_torch.utils import build; "
         "print(build.cuda_library_path('toy_scale.cu')); print(build.build_library.compiles)"],
        cwd=str(build.CSRC_DIR), env=env, capture_output=True, text=True, check=True)
    other_lib, other_compiles = proc.stdout.split()
    print(f"toy library {toy_lib.name}: asked again from {build.CSRC_DIR.name}/ in a "
          f"subprocess: {Path(other_lib).name}, {other_compiles} compiler runs there")
    _check(other_lib == str(toy_lib) and other_compiles == "0",
           f"the toy library resolved to {other_lib} with {other_compiles} compiler runs")
    _check(build.build_library.compiles == compiles, "the toy library was compiled twice")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 256), np.float32)).to(dev)
    build.toy_scale.launches = 0  # the toy's path: one launch of the cached library
    y = build.toy_scale(x)
    toy_launches = build.toy_scale.launches
    _check(toy_launches == 1 and torch.equal(y, x * 2.0), "the toy kernel differs from x * 2")
    # the toy at the reference's shape and at 4096^2 (64 MiB each way): the
    # wrapper, the kernel alone (the C launch on prepared pointers), x * 2.0
    # and torch.mul, each equal to x * 2 bit for bit; then an odd length and
    # a misaligned view (x[1:]), which takes the scalar body
    toy_fn = build.load_toy_kernel()
    for side in (256, 4096):
        xs = x if side == 256 else torch.from_numpy(np.random.default_rng(1).standard_normal(
            (side, side), np.float32)).to(dev)
        _check(torch.equal(build.toy_scale(xs), xs * 2.0), f"the toy kernel differs at {side}^2")
        out, stream = torch.empty_like(xs), build.current_stream(dev.index)
        row = dict(max_abs_err=0.0, ms=_cuda_ms(lambda: build.toy_scale(xs), 50),
                   plain_ms=_cuda_ms(lambda: xs * 2.0, 50),
                   library_ms=_cuda_ms(lambda: torch.mul(xs, 2.0), 50),
                   **dict(zip(("bound_ms", "bound_by"), bound(xs.numel(), xs.numel() * 8))))
        alone = _cuda_ms(lambda: toy_fn(xs.data_ptr(), out.data_ptr(), xs.numel(), dev.index,
                                        stream), 50)
        _check(torch.equal(out, xs * 2.0), f"the toy kernel alone differs at {side}^2")
        if other_toy is not None:
            args = (xs.data_ptr(), out.data_ptr(), xs.numel(), dev.index, stream)
            pfn, pparams = other_toy
            pargs = _bind(pparams, _c_params(build.CSRC_DIR / "toy_scale.cu",
                                             "toy_scale_launch"), args)
            out.zero_()
            _check(pfn(*pargs) == 0 and torch.equal(out, xs * 2.0),
                   f"the other checkout's toy kernel differs at {side}^2")
            print(_in_turns(f"toy_scale ({side}x{side}), the other checkout's kernel alone "
                            f"against this one's", lambda: pfn(*pargs),
                            lambda: toy_fn(*args), 50))
        print(f"toy_scale ({side}x{side}): equal to x * 2 bit for bit; wrapper {row['ms']:.4f} "
              f"ms, kernel alone {alone:.4f} ms, plain (x * 2.0) {row['plain_ms']:.4f} ms, "
              f"library (torch.mul) {row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
              f"(share of the wrapper's time {row['bound_ms'] / row['ms']:.4f}, of the kernel "
              f"alone's {row['bound_ms'] / alone:.4f})")
        if side == 256:
            kernels_toy = row
            # the launch path the other wrappers (K1, K2, the probes) take
            # on every call: a Stream object for the stream's handle, inside
            # torch.cuda.device; the toy's: the raw handle, no switch
            def via_stream():
                return toy_fn(xs.data_ptr(), out.data_ptr(), xs.numel(), dev.index,
                              torch.cuda.current_stream(dev).cuda_stream)

            def via_switch():
                with torch.cuda.device(dev):
                    return via_stream()

            print(f"launch path at {side}x{side}: the toy kernel with its stream read by "
                  f"torch.cuda.current_stream(dev).cuda_stream {_cuda_ms(via_stream, 50):.4f} ms, "
                  f"and inside torch.cuda.device(dev) {_cuda_ms(via_switch, 50):.4f} ms, against "
                  f"{alone:.4f} ms alone and {row['ms']:.4f} ms through the wrapper")
        del xs, out
    base = torch.randn(65_540, device=dev)
    for what, view in (("an odd length (65,539)", base[:65_539]),
                       ("a misaligned view (x[1:])", base[1:])):
        _check(torch.equal(build.toy_scale(view), view * 2.0),
               f"the toy kernel differs from x * 2 on {what}")
    print("toy_scale: equal to x * 2 on an odd length (65,539) and a misaligned view (x[1:])")
    _phase("build", t0)

    # ---- 2b. asset: the flagship GLB through the port's own writer and reader ----
    t0 = time.perf_counter()
    app.REALGLB_PATH.parent.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    sample_asset.build_sponza_class_glb(app.REALGLB_PATH)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    glb = gltf._Gltf(app.REALGLB_PATH)
    n_images = len([glb.image_pixels(i) for i in range(len(glb.json["images"]))])
    decode_s = time.perf_counter() - t
    t = time.perf_counter()
    realglb = app.load_any_scene("realglb")
    load_s = time.perf_counter() - t
    b = realglb.buffers
    t = time.perf_counter()
    host = b.to("cpu")
    world_tris = bvh_ops.world_triangles(geometry.to_world(host).position, host.tri_vertex)
    rg_bvh = bvh8_ops.build_bvh8_sah_host(world_tris.numpy())
    bvh_s = time.perf_counter() - t
    counts = dict(triangles=b.num_triangles, primitives=b.prim_transform.shape[0],
                  textures=b.atlas.uv_offset.shape[0], alpha_masked=b.alpha_tri_idx.shape[0],
                  atlas=tuple(b.atlas.data.shape), images=n_images)
    print(f"realglb ({app.REALGLB_PATH.stat().st_size} bytes): write {write_s:.3f} s, decode "
          f"of its {n_images} PNGs {decode_s:.3f} s, load_scene {load_s:.3f} s, host BVH8 "
          f"{bvh_s:.3f} s ({rg_bvh.num_rows} rows, depth bound {rg_bvh.depth}, "
          f"{rg_bvh.num_rows * 512} bytes); counts {counts}")
    _check(counts == dict(triangles=254_636, primitives=370, textures=39, alpha_masked=600,
                          atlas=(4, 72, 2560), images=39),
           f"realglb's counts differ from the reference writer's: {counts}")
    img = np.random.default_rng(1).integers(0, 256, (1024, 1024, 4), dtype=np.uint8)
    t = time.perf_counter()
    blob = png.encode_png(img)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    back = png.decode_png(blob)
    dec_s = time.perf_counter() - t
    print(f"PNG round trip of a 1024x1024 RGBA image: encode {enc_s:.3f} s, decode "
          f"{dec_s:.3f} s, equal {np.array_equal(back, img)}")
    _check(np.array_equal(back, img), "the PNG round trip is not exact")
    # the same asset with the reference's atlas_dtype=bf16: half the atlas's
    # bytes, every sampler reading it back as float32
    t = time.perf_counter()
    realglb16 = gltf.load_scene(app.REALGLB_PATH, atlas_dtype=torch.bfloat16)
    load16_s = time.perf_counter() - t
    a32, a16 = realglb.buffers.atlas.data, realglb16.buffers.atlas.data
    atlas_bytes = (a32.nbytes, a16.numel() * a16.element_size())
    print(f"realglb with atlas_dtype=torch.bfloat16: load_scene {load16_s:.3f} s, atlas "
          f"{tuple(a16.shape)} {a16.dtype}: {atlas_bytes[1]} bytes against {atlas_bytes[0]} in "
          f"float32")
    _check(a16.dtype == torch.bfloat16 and atlas_bytes[1] * 2 == atlas_bytes[0]
           and torch.equal(a16, torch.from_numpy(a32).to(torch.bfloat16)),
           "the bf16 atlas is not the f32 atlas rounded to nearest, at half its bytes")
    del host, world_tris, rg_bvh, img, back, a32, a16
    _phase("asset", t0)

    # ---- 2c. jpeg kinds: the JPEGs beyond Huffman DCT that the reference reads ----
    t0 = time.perf_counter()
    jpgs = sorted(f.stem for f in JPEG_FIXTURES.glob("*.jpg"))
    _check(bool(jpgs) and jpgs == sorted(f.stem for f in JPEG_FIXTURES.glob("*.npy")),
           f"jpeg fixtures {jpgs} are not each beside its Pillow decode (.npy)")
    streams, goldens = {}, {}
    for f in sorted(JPEG_FIXTURES.glob("*.jpg")):
        data, golden = f.read_bytes(), np.load(f.with_suffix(".npy"))
        t = time.perf_counter()
        got = decode_jpeg(data)
        decode_s = time.perf_counter() - t
        same = got.shape == golden.shape and np.array_equal(got, golden)
        print(f"jpeg {f.stem} ({len(data)} bytes, {golden.shape[1]}x{golden.shape[0]}): host "
              f"decode {decode_s:.4f} s ({smi}), equal to Pillow's decode {same}")
        _check(same, f"decode_jpeg({f.name}) differs from Pillow's decode")
        streams[f.stem], goldens[f.stem] = data, golden
    board_path = build.BUILD_DIR / "jpeg_kinds.glb"
    sample_asset.build_texture_board_glb(board_path, list(streams.values()))
    t = time.perf_counter()
    board = gltf.load_scene(board_path)
    load_s = time.perf_counter() - t
    want = build_atlas(list(goldens.values()), [True] * len(goldens))  # base colours: sRGB
    _check(np.array_equal(np.asarray(board.buffers.atlas.data), want.data),
           "the texture board's atlas is not the atlas of Pillow's decodes")
    r = Renderer(board, RenderConfig(width=320, height=180, hybrid=full, alpha_raster="brute"),
                 device=dev)
    r.render_frame()
    img = r.render_frame()
    _check(img.device.type == "cuda", f"the jpeg kinds frame is on {img.device}")
    img = img.cpu().numpy()
    print(f"jpeg kinds: {len(streams)} streams as the textures of a glTF, load_scene "
          f"{load_s:.3f} s, atlas {tuple(want.data.shape)} equal to Pillow's decodes; frame 2 "
          f"of the flagship configuration at 320x180 on {img.shape} finite "
          f"{bool(np.isfinite(img).all())}, mean {float(img[:3].mean()):.4f}")
    _check(img.shape == (4, 180, 320) and np.isfinite(img).all() and img[:3].max() > 0,
           "the jpeg kinds frame is not finite or is black")
    del r, board, img
    _phase("jpeg kinds", t0)

    # ---- 3. golden ---------------------------------------------------------------
    t0 = time.perf_counter()
    raster_hs = cfgmod.HybridSettings(shadow_mode=cfgmod.ShadowMode.RASTERIZED,
                                      ao_mode=cfgmod.AmbientOcclusionMode.SSAO)
    for name, path, hs, frames, make_scene in (
            ("hybrid_rt_shadows_cornell", "hybrid", cfgmod.HybridSettings(), 1,
             procedural.cornell_box),
            ("hybrid_full_cornell", "hybrid", full, 2, procedural.cornell_box),
            ("forward_cornell", "forward", cfgmod.HybridSettings(), 1, procedural.cornell_box),
            ("hybrid_raster_shadows_ssao", "hybrid", raster_hs, 1, procedural.cornell_box),
            ("raytraced_cornell", "raytraced", cfgmod.HybridSettings(), 1,
             procedural.cornell_box),
            ("rayquery_checker", "rayquery", cfgmod.HybridSettings(), 1,
             procedural.checker_quad)):
        r = Renderer(make_scene(),
                     RenderConfig(width=64, height=64, shadow_map_size=128, hybrid=hs),
                     path=path, device=dev)
        for _ in range(frames):
            img = r.render_frame().cpu().numpy()
        golden = np.load(GOLDENS / f"{name}.npy").astype(np.float32)
        err = float(np.sqrt(np.mean((np.clip(img, 0, 1) - np.clip(golden, 0, 1)) ** 2)))
        print(f"golden {name} 64x64 after {frames} frame(s): RMSE {err:.6f} (limit 2e-3)")
        _check(np.isfinite(img).all() and err <= 2e-3, f"golden {name} RMSE {err}")
    # the Atrium, written and read by the port, in the forward path; its
    # near depth ties (the floor and the columns' bottom faces, coplanar)
    # z-fight, decided by the last bits of each setup (rt.depth_ties)
    atrium_path = build.BUILD_DIR / "atrium.glb"
    sample_asset.build_sample_glb(atrium_path)
    r = Renderer(gltf.load_scene(atrium_path),
                 RenderConfig(width=96, height=96, shadow_map_size=128), path="forward",
                 device=dev)
    img = r.render_frame().cpu().numpy()
    ties = rt.depth_ties(r.buffers, r.fetch_resources("Clip")["Clip"], 96, 96).cpu().numpy()
    sq = (np.clip(img, 0, 1) - np.clip(np.load(GOLDENS / "atrium_forward.npy")
                                       .astype(np.float32), 0, 1)) ** 2
    err = float(np.sqrt(sq[:, ~ties].mean()))
    print(f"golden atrium_forward 96x96 (the port's GLB writer and reader): RMSE {err:.6f} "
          f"over the {int((~ties).sum())} pixels without a near depth tie (limit 2e-3), "
          f"{float(np.sqrt(sq.mean())):.6f} over all {96 * 96}; near ties {int(ties.sum())} "
          f"(limit {0.005 * 96 * 96:.0f})")
    _check(np.isfinite(img).all() and err <= 2e-3 and 0 < ties.sum() <= 0.005 * 96 * 96,
           f"golden atrium_forward RMSE {err}, {int(ties.sum())} near ties")
    del r
    _phase("golden", t0)

    # ---- 4. kernels against their plain versions at the slice's shapes -----------
    t0 = time.perf_counter()
    scene = procedural.sponza_proxy()
    full_cfg = RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="brute",
                            alpha_peel_rounds=4, ao_rays=2, hybrid=full)
    r = Renderer(scene, full_cfg, device=dev)
    r.render_frame()
    res = r.fetch_resources("pfd", "Clip", "BVH", "shade_tables", "WorldTris",
                            hybrid_path.DEPTH, hybrid_path.NORMALS)
    pfd, clip, bvh, tables = res["pfd"], res["Clip"], res["BVH"], res["shade_tables"]
    depth, normals = res[hybrid_path.DEPTH], res[hybrid_path.NORMALS]
    buffers = r.buffers
    print(f"scene {scene.name}: {buffers.num_triangles} triangles "
          f"({buffers.alpha_tri_idx.shape[0]} alpha-masked), BVH8 {bvh.num_rows} rows, "
          f"depth bound {bvh.depth}; " + _validate(bvh8_ops, bvh, res["WorldTris"], "its SAH BVH8"))
    kernels = {}

    def k1_bound(mode, planes_, bins, tiles_px, samples=1, listed=None):
        """A raster call's bound (ms, what sets it), the dense test's bound
        ms, its entries and the (entry, sub-tile) pairs that pass.  Bytes:
        the plane rows its entries name, the entries and offsets, the peel
        bound of its pixels, its outputs.  Operations: rt.raster_ops
        of the pairs rt.subtile_masks passes (K1d: on some sample), against
        those of testing every (entry, pixel) pair."""
        keep = None if listed is None else torch.isin(rt.entry_tiles(bins), listed.long())
        live = rt.live_entry_tri(bins)  # offsets[-1] of the cap's entries
        ids = live if keep is None else live[keep]
        masks = rt.subtile_masks(planes_, bins, samples=samples if mode == "K1d" else None)
        if mode == "K1d":
            masks = functools.reduce(torch.bitwise_or, masks.unbind(0))
        if keep is not None:
            masks = masks[keep]
        n_e, n_pass = int(ids.shape[0]), rt.passing_pairs(masks)
        nbytes = (int(torch.unique(ids).shape[0]) * 48 + n_e * 4 + bins.offsets.shape[0] * 4
                  + tiles_px * (8 if mode in ("K1b", "K1c") else 0) + tiles_px * 20 * samples)
        ops, dense = rt.raster_ops(n_e, n_pass, mode, samples)
        b_ms, b_by = bound(ops, nbytes)
        return dict(bound_ms=b_ms, bound_by=b_by, dense_bound_ms=bound(dense, nbytes)[0],
                    entries=n_e, pairs=n_pass)

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("tri_id", "depth", "bary"))

    def k1_equal(label, got, want) -> float:
        """K1's gate: depth, tri id and bary equal to `want` on every pixel
        (lists: of every sample).  Returns the largest difference (0.0)."""
        pairs = list(zip(got, want)) if isinstance(got, list) else [(got, want)]
        ok = all(same(a, b) for a, b in pairs)
        err = max(max(_max_abs(a.depth - b.depth), _max_abs(a.bary - b.bary),
                      float((a.tri_id != b.tri_id).sum())) for a, b in pairs)
        print(f"{label}: {'equal on every pixel' if ok else f'DIFFERS (max {err:.3g})'}")
        _check(ok, f"{label}: depth, tri id or bary differ")
        return err

    def k1_line(name, k, ms, plain_ms=None):
        print(f"{name}: {k['entries']} entries, {k['pairs']} (entry, sub-tile) pairs pass of "
              f"{k['entries'] * rt.N_SUBTILES} ({k['pairs'] / max(k['entries'] * rt.N_SUBTILES, 1):.4f}); "
              f"kernel {ms:.4f} ms" + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else "")
              + f", bound {k['bound_ms']:.4f} ms (set by {k['bound_by']}; share {k['bound_ms'] / ms:.4f}), "
              f"dense bound {k['dense_bound_ms']:.4f} ms")

    def k1_flagship(label, buffers, clip, tables, record):
        """Every K1 instance of a full frame's G-buffer (K1a on every triangle
        and on the opaque stream, K1b rounds 1 and 2, K1c on round 2's live
        tiles) against its plain version on every pixel, with its time and
        bound; with `record`, the entries of the JSON line."""
        setup = triangle_setup(clip, buffers.tri_vertex, WIDTH, HEIGHT)
        planes = setup.planes
        # K1a: every triangle (the RT-shadows slice's opaque stream)
        bins = rt.bin_triangles(setup, WIDTH, HEIGHT)
        err = k1_equal(f"{label}K1a raster_tile, every triangle",
                       rt.raster_tiles(planes, bins, WIDTH, HEIGHT),
                       rt.raster_tiles_plain(planes, bins, WIDTH, HEIGHT))
        # and the full frame's opaque stream (every triangle but the masked ones)
        opaque = buffers.materials.alpha_mask[buffers.tri_prim.long()] != 1
        obins = rt.bin_triangles(setup, WIDTH, HEIGHT, include=opaque)
        err_o = k1_equal(f"{label}K1a raster_tile, full frame's opaque stream",
                         rt.raster_tiles(planes, obins, WIDTH, HEIGHT),
                         rt.raster_tiles_plain(planes, obins, WIDTH, HEIGHT))
        ms = _cuda_ms(lambda: rt.raster_tiles(planes, bins, WIDTH, HEIGHT), 20)
        plain_ms = _cuda_ms(lambda: rt.raster_tiles_plain(planes, bins, WIDTH, HEIGHT), 2)
        kb = k1_bound("K1a", planes, bins, WIDTH * HEIGHT)
        if record:
            kernels["K1a"] = dict(max_abs_err=max(err, err_o), ms=ms, plain_ms=plain_ms, **kb)
        k1_line(f"{label}K1a raster_tile, every triangle", kb, ms, plain_ms)
        ko = k1_bound("K1a", planes, obins, WIDTH * HEIGHT)
        print(f"{label}K1a raster_tile, full frame's opaque stream (not timed here): "
              f"{ko['entries']} entries, {ko['pairs']} (entry, sub-tile) pairs pass; bound "
              f"{ko['bound_ms']:.4f} ms "
              f"(set by {ko['bound_by']}), dense bound {ko['dense_bound_ms']:.4f} ms")

        # K1b / K1c: the alpha-masked stream, round 1 and the real round-2 bound
        include = torch.zeros(buffers.num_triangles, dtype=torch.bool, device=dev)
        include[buffers.alpha_tri_idx.long()] = True
        mbins = rt.bin_triangles(setup, WIDTH, HEIGHT, include=include)
        zc1 = torch.full((HEIGHT, WIDTH), rt.BIG, device=dev)
        tc1 = torch.full((HEIGHT, WIDTH), 2**31 - 1, dtype=torch.int32, device=dev)
        v1 = rt.raster_tiles_peel(planes, mbins, WIDTH, HEIGHT, zc1, tc1)
        err1 = k1_equal(f"{label}K1b raster_tile peel bound, round 1", v1,
                        rt.raster_tiles_plain(planes, mbins, WIDTH, HEIGHT, zc1, tc1))
        _, killed = rt.alpha_test(tables, v1)
        zc2, tc2 = rt.peel_bound(v1, killed)
        v2 = rt.raster_tiles_peel(planes, mbins, WIDTH, HEIGHT, zc2, tc2)
        err2 = k1_equal(f"{label}K1b raster_tile peel bound, round 2 ({int(killed.sum())} "
                        "killed pixels)", v2,
                        rt.raster_tiles_plain(planes, mbins, WIDTH, HEIGHT, zc2, tc2))
        ms = _cuda_ms(lambda: rt.raster_tiles_peel(planes, mbins, WIDTH, HEIGHT, zc1, tc1), 20)
        plain_ms = _cuda_ms(lambda: rt.raster_tiles_plain(planes, mbins, WIDTH, HEIGHT, zc1, tc1), 2)
        kb = k1_bound("K1b", planes, mbins, WIDTH * HEIGHT)
        if record:
            kernels["K1b"] = dict(max_abs_err=max(err1, err2), ms=ms, plain_ms=plain_ms, **kb)
        k1_line(f"{label}K1b raster_tile peel bound, round 1, masked stream", kb, ms, plain_ms)

        # the peel's list: every tile's slot, the live ones first, their count
        # on the device; K1c launches a block a slot
        tiles, n_live = rt.live_tiles(killed, mbins.ntx, mbins.nty)
        n_tiles = int(n_live)
        _check(n_tiles > 0, f"{label}round 2 of the peel has no live tile on this scene: "
               "K1c would never launch")
        v2c = rt.raster_tiles_compact(planes, mbins, WIDTH, HEIGHT, zc2, tc2, tiles, n_live)
        c_err = max(k1_equal(f"{label}K1c raster_tile compact, round 2's live tiles", v2c,
                             rt.raster_tiles_plain(planes, mbins, WIDTH, HEIGHT, zc2, tc2, tiles,
                                                   n_live)),
                    k1_equal(f"{label}K1c against K1b's full-width round 2", v2c, v2))
        # a list cut to its live slots (the launch shape before the count
        # moved to the device) gives the same pixels
        short, n_short = tiles[:n_tiles].contiguous(), n_live.clone()
        c_err = max(c_err, k1_equal(f"{label}K1c over the list cut to its {n_tiles} live slots",
                                    rt.raster_tiles_compact(planes, mbins, WIDTH, HEIGHT, zc2,
                                                            tc2, short, n_short), v2c))
        # the kernel alone: the wrapper's clear of the whole image (20 bytes a
        # pixel) is made once, before the timing window; re-launching into it
        # rewrites the listed tiles with the same values
        pre = rt.clear_visibility(WIDTH, HEIGHT, dev)
        ms = _cuda_ms(lambda: rt.launch("K1c", planes, mbins, WIDTH, HEIGHT, pre, zc2, tc2,
                                        tiles, n_live=n_live), 20)
        short_ms = _cuda_ms(lambda: rt.launch("K1c", planes, mbins, WIDTH, HEIGHT, pre, zc2, tc2,
                                              short, n_live=n_short), 20)
        wrapper_ms = _cuda_ms(
            lambda: rt.raster_tiles_compact(planes, mbins, WIDTH, HEIGHT, zc2, tc2, tiles,
                                            n_live), 20)
        _check(same(pre, v2c), "K1c's timed launches changed its output")
        plain_ms = _cuda_ms(lambda: rt.raster_tiles_plain(planes, mbins, WIDTH, HEIGHT, zc2, tc2,
                                                          tiles, n_live), 2)
        kb = k1_bound("K1c", planes, mbins, n_tiles * 1024, listed=tiles)
        if record:
            kernels["K1c"] = dict(max_abs_err=c_err, ms=ms, plain_ms=plain_ms, **kb)
        k1_line(f"{label}K1c raster_tile compact, {n_tiles} live tiles of round 2 in a list of "
                f"{tiles.shape[0]} slots (a block a slot)", kb, ms, plain_ms)
        print(f"{label}K1c over the list cut to its {n_tiles} live slots: {short_ms:.4f} ms "
              f"(the full list's {tiles.shape[0] - n_tiles} idle blocks cost "
              f"{ms - short_ms:.4f} ms)")
        print(f"{label}K1c wrapper (clear of {WIDTH * HEIGHT * 20} bytes + kernel) "
              f"{wrapper_ms:.4f} ms")
        trace = []
        _, overflow_m = rt.rasterize_alpha_peeled(buffers, setup, WIDTH, HEIGHT, tables,
                                                  rounds=4, trace=trace)
        _check(int(overflow_m[0]) == 0, f"{label}the masked stream's binning overflowed")
        print(f"{label}peel rounds: " + "; ".join(
            f"round {t['round']}: {t['tiles']} tiles rastered, {t['killed']} pixels killed"
            for t in trace))

    k1_flagship("", buffers, clip, tables, record=True)
    opaque = buffers.materials.alpha_mask[buffers.tri_prim.long()] != 1

    def hybrid_wavefronts(rays, ao_rays):
        """name -> (origin, dir, tmax, any-hit) of a hybrid frame's rays."""
        return {
            "shadow": (rays.origin, rays.shadow_dir, rays.shadow_tmax, True),
            "AO": (rays.origin.repeat(ao_rays, 1), rays.ao_dir, rays.ao_tmax.repeat(ao_rays),
                   True),
            "reflection": (rays.origin, rays.refl_dir, rays.refl_tmax, False),
        }

    k2_errs = {}  # K2 entry of the JSON line -> max_abs_err over every wavefront
    rows_live = {}  # k2_wave's label -> rows K2 visits a live ray

    def k2_wave(bvh, label, o, d, tmin, tmax, anyhit, tables=None, plain_timed=False,
                extra_bytes=0, all_fields=False):
        """K2 on one wavefront against trace_plain on the same rays, on the
        table's kind: closest-hit (and with `all_fields` any-hit too) t,
        tri, u and v equal on every ray, any-hit hit masks identical.
        Prints rays, live rays, the walk's internal and leaf rows (and
        filter evaluations), the kernel's ms and the bound recounted from
        them (a bf16 table's decode included).  Returns the JSON line's
        fields."""
        n = o.shape[0]
        tmin_a = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(n).contiguous()
        filt = None if tables is None else traverse.make_alpha_hit_filter(None, tables)
        steps = traverse.default_max_steps(bvh)
        kind = bvh.kind
        mode = ("filtered " if tables is not None else "") + ("any-hit" if anyhit else "closest-hit")
        name = _k2_name(kind, mode)
        k = traverse.trace(bvh, None, o, d, tmin_a, tmax, anyhit=anyhit, alpha_tables=tables)
        p, vis = traverse.trace_plain(bvh.rows, bvh.depth, o, d, tmin_a, tmax, anyhit, steps,
                                      filt, visits=True, leaf_max=bvh.leaf_max)
        if anyhit and not all_fields:
            err = float((k.hit != p.hit).sum())
            agree = f"mismatched hit flags {int(err)}"
            _check(err == 0.0, f"{name} hit masks differ on the {label} rays")
        else:
            diff = {f: int((getattr(k, f) != getattr(p, f)).sum()) for f in ("t", "tri", "u", "v")}
            err = max(_max_abs(k.t - p.t), _max_abs(k.u - p.u), _max_abs(k.v - p.v),
                      float(diff["tri"]))
            agree = "rays whose t / tri / u / v differ " + " / ".join(map(str, diff.values()))
            _check(not any(diff.values()),
                   f"{name} differs from its plain version on the {label} rays: {diff}")
        k2_errs[name] = max(k2_errs.get(name, 0.0), err)
        ms = _cuda_ms(lambda: traverse.trace(bvh, None, o, d, tmin_a, tmax, anyhit=anyhit,
                                             alpha_tables=tables), 10)
        plain_ms = None
        if plain_timed:
            plain_ms = _cuda_ms(lambda: traverse.trace_plain(
                bvh.rows, bvh.depth, o, d, tmin_a, tmax, anyhit, steps, filt), 1)
        internal, leaf, boxes, tris, evals = (
            int(x.sum()) for x in (vis.internal, vis.leaf, vis.boxes, vis.triangles, vis.filtered))
        empty = 8 * internal + bvh.leaf_max * leaf - boxes - tris
        ops = (boxes * K2_OPS_BOX + tris * K2_OPS_TRI + empty * K2_OPS_EMPTY
               + evals * K2_OPS_FILTER)
        if kind == "bf16-8":
            ops += tris * K2_OPS_DECODE_TRI
        # bytes: rays in (origin, direction, tmin, tmax), hits out, the table
        # the kernel reads once (the f32 leaf-8 rows, or the other kinds'
        # packed copy: 512 bytes a row in f32, 256 in bf16)
        table = traverse.kernel_table(bvh)
        nbytes = (n * (12 + 12 + 4 + 4) + n * 16 + table.numel() * table.element_size()
                  + extra_bytes)
        b_ms, b_by = bound(ops, nbytes)
        live = int((tmax >= tmin_a).sum())
        rows_live[label] = (internal + leaf) / max(live, 1)
        # a warp walks its 8 rays until the longest ends: the share of its
        # ray-steps that visit a row
        walk = (vis.internal + vis.leaf).float()
        walk = torch.cat([walk, walk.new_zeros((-n) % 8)]).reshape(-1, 8)
        busy = float(walk.sum() / (walk.amax(dim=1).sum() * 8).clamp(min=1))
        print(f"{name} bvh8_trace, {label} rays: {n} ({live} live), hits {int(k.hit.sum())}, "
              f"{agree}; visits: internal rows {internal} ({boxes} boxes), leaf rows {leaf} "
              f"({tris} triangles)"
              + (f", filter evaluations {evals}" if tables is not None else "")
              + f" ({(internal + leaf) / max(live, 1):.2f} rows a live ray, {busy:.3f} of a warp's "
              f"ray-steps); kernel {ms:.4f} ms"
              + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else "")
              + f", bound {b_ms:.4f} ms (set by {b_by}; operations {ops / fp32_per_s * 1e3:.4f}"
              f", bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f}), share of the bound {b_ms / ms:.4f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    def check_k2(bvh, wavefronts, label, timed, record=True):
        """k2_wave on each wavefront of a hybrid frame; with `timed`, the
        plain version's time too, and the AO (any-hit) and reflection
        (closest-hit) wavefronts' numbers go to the JSON line unless
        `record` is false."""
        for name, (o, d, tmax, anyhit) in wavefronts.items():
            entry = k2_wave(bvh, f"{label} {name}", o, d, raygen.SHADOW_TMIN, tmax, anyhit,
                            plain_timed=timed)
            if timed and record and name != "shadow":
                kernels[f"K2 {'any-hit' if anyhit else 'closest-hit'}"] = entry

    def k2_kinds(label, b8, tris, rays, tables, record):
        """K2's other row kinds on a full frame's wavefronts: the bf16 rows
        of b8 (table_to_bf16) and the f32 leaf-12 rows of the same
        triangles' SAH tree, each against its plain version on every ray
        (t, tri, u and v, any-hit too) on the shadow, AO and reflection
        rays, and through the alpha filter on the shadow and reflection
        rays, with its bound, timed beside K2 on b8 (f32 leaf-8) on the same
        rays.  With `record`, the AO (any-hit), reflection (closest-hit) and
        filtered numbers are the JSON line's entries of each kind."""
        kinds = {"bf16-8": bvh8_ops.table_to_bf16(b8),
                 "f32-12": bvh8_ops.build_bvh8_sah_host(tris.cpu().numpy(), leaf_max=12).to(dev)}
        print(f"{label} table kinds: " + "; ".join(
            f"{b.kind} {b.num_rows} rows, {b.table_bytes} bytes, depth bound "
            f"{b.depth}" for b in (b8, *kinds.values())))
        waves = {w: (*v, None) for w, v in hybrid_wavefronts(rays, 2).items()}
        waves["filtered shadow"] = waves["shadow"][:4] + (tables,)
        waves["filtered reflection"] = waves["reflection"][:4] + (tables,)
        for kind, b in kinds.items():
            for w, (o, d, tmax, anyhit, tabs) in waves.items():
                entry = k2_wave(b, f"{label} {kind} {w}", o, d, raygen.SHADOW_TMIN, tmax,
                                anyhit, tabs, plain_timed=True, all_fields=True)
                f8_ms = _cuda_ms(lambda: traverse.trace(b8, None, o, d, raygen.SHADOW_TMIN, tmax,
                                                        anyhit=anyhit, alpha_tables=tabs), 10)
                print(f"K2 {kind} against f32-8 on the {label} {w} rays: {entry['ms']:.4f} ms "
                      f"against {f8_ms:.4f} ms (ratio {entry['ms'] / f8_ms:.3f})")
                if other_k2 is not None:
                    print(_k2_parent(other_k2, b, f"{label} {w}", o, d, raygen.SHADOW_TMIN,
                                     tmax, anyhit, tabs, k2_packed))
                    if kind == "bf16-8":  # the f32 leaf-8 kernel on the same rays
                        print(_k2_parent(other_k2, b8, f"{label} {w}", o, d,
                                         raygen.SHADOW_TMIN, tmax, anyhit, tabs, k2_packed))
                if record and w != "shadow":
                    mode = ("filtered " if tabs is not None else "") + (
                        "any-hit" if anyhit else "closest-hit")
                    kernels[_k2_name(kind, mode)] = dict(entry, f32_8_ms=f8_ms)
        del kinds

    rays = raygen.Wavefronts(pfd, depth, normals, full, ao_rays=2)
    check_k2(bvh, hybrid_wavefronts(rays, 2), "full frame's", timed=True)
    k2_kinds("SponzaProxy full frame's", bvh, res["WorldTris"], rays, tables, record=False)
    del r, res, rays
    torch.cuda.empty_cache()

    # the same K1 and K2 instances on main path 8's frame: realglb, the
    # flagship asset, second frame, on its f32 leaf-8 SAH table (its default
    # table is bf16: k2_kinds below, and main path 8)
    r = Renderer(realglb, dataclasses.replace(full_cfg, bvh_dtype="f32", bvh_leaf_max=8),
                 device=dev)
    r.render_frame()
    res = r.fetch_resources("pfd", "Clip", "BVH", "shade_tables", "WorldTris", hybrid_path.DEPTH,
                            hybrid_path.NORMALS)
    print(f"scene {realglb.name}: {r.buffers.num_triangles} triangles "
          f"({r.buffers.alpha_tri_idx.shape[0]} alpha-masked), BVH8 {res['BVH'].num_rows} rows, "
          f"depth bound {res['BVH'].depth}; "
          + _validate(bvh8_ops, res["BVH"], res["WorldTris"], "its SAH BVH8"))
    k1_flagship("realglb: ", r.buffers, res["Clip"], res["shade_tables"], record=False)
    rays = raygen.Wavefronts(res["pfd"], res[hybrid_path.DEPTH], res[hybrid_path.NORMALS], full,
                             ao_rays=2)
    check_k2(res["BVH"], hybrid_wavefronts(rays, 2), "realglb full frame's", timed=True,
             record=False)
    k2_kinds("realglb full frame's", res["BVH"], res["WorldTris"], rays, res["shade_tables"],
             record=True)
    # the device LBVH and K4, the threaded walk, on the same frame: K4
    # against its plain version on every ray, against K2 on the SAH BVH8 (the
    # oracle), the refit; then K2 over the LBVH's BVH8 (main path 12's tree)
    lbvh, k4_entries = _lbvh_oracle(res["WorldTris"], res["BVH"], hybrid_wavefronts(rays, 2),
                                    bound, res["shade_tables"], other_k4)
    kernels.update(k4_entries)
    lbvh8 = bvh8_ops.build_bvh8_host(lbvh, res["WorldTris"].cpu().numpy()).to(dev)
    print(f"realglb: the device LBVH's BVH8 {lbvh8.num_rows} rows, depth bound {lbvh8.depth}; "
          f"the SAH BVH8 {res['BVH'].num_rows} rows, depth bound {res['BVH'].depth}")
    check_k2(lbvh8, hybrid_wavefronts(rays, 2), "realglb full frame's (LBVH BVH8)", timed=False)
    del r, res, rays, lbvh, lbvh8
    torch.cuda.empty_cache()

    # K1d and the shadow map's K1a, on the forward configuration's second frame
    fwd_cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                           forward=cfgmod.ForwardSettings(msaa_samples=4))
    r = Renderer(scene, fwd_cfg, path="forward", device=dev)
    r.render_frame()
    res = r.fetch_resources("Clip", "LightClip")
    setup = triangle_setup(res["Clip"], buffers.tri_vertex, WIDTH, HEIGHT)
    planes = setup.planes
    obins = rt.bin_triangles(setup, WIDTH, HEIGHT, include=opaque)

    def offset_k1a(samples):
        return [rt.raster_tiles(p_, obins, WIDTH, HEIGHT) for p_ in
                [rt.offset_planes(planes, sx / 16.0, sy / 16.0)
                 for sx, sy in rt.MSAA_PATTERNS[samples]]]

    d_err = 0.0
    for k in (2, 4, 8):
        d_err = max(d_err, k1_equal(f"K1d raster_tile_msaa, {k} samples, forward frame's opaque "
                                    "stream", rt.raster_tiles_msaa(planes, obins, WIDTH, HEIGHT, k),
                                    rt.raster_tiles_msaa_plain(planes, obins, WIDTH, HEIGHT, k)))
    for k in (4, 8):
        k1_equal(f"K1d at {k} samples against {k} K1a launches on offset_planes",
                 rt.raster_tiles_msaa(planes, obins, WIDTH, HEIGHT, k), offset_k1a(k))
    ms = _cuda_ms(lambda: rt.raster_tiles_msaa(planes, obins, WIDTH, HEIGHT, 4), 20)
    shifted = [rt.offset_planes(planes, sx / 16.0, sy / 16.0) for sx, sy in rt.MSAA_PATTERNS[4]]
    k1a4_ms = _cuda_ms(lambda: [rt.raster_tiles(p_, obins, WIDTH, HEIGHT) for p_ in shifted], 20)
    plain_ms = _cuda_ms(lambda: rt.raster_tiles_msaa_plain(planes, obins, WIDTH, HEIGHT, 4), 2)
    kb = k1_bound("K1d", planes, obins, WIDTH * HEIGHT, samples=4)
    kernels["K1d"] = dict(max_abs_err=d_err, ms=ms, plain_ms=plain_ms, **kb)
    k1_line("K1d raster_tile_msaa, 4 samples (a pair passes on some sample)", kb, ms, plain_ms)
    print(f"K1d: the four K1a launches it replaces {k1a4_ms:.4f} ms")

    size = fwd_cfg.shadow_map_size
    lsetup = triangle_setup(res["LightClip"], buffers.tri_vertex, size, size)
    lbins = rt.bin_triangles(lsetup, size, size)
    err_l = k1_equal(f"K1a raster_tile, shadow map {size}x{size}",
                     rt.raster_tiles(lsetup.planes, lbins, size, size),
                     rt.raster_tiles_plain(lsetup.planes, lbins, size, size))
    ms = _cuda_ms(lambda: rt.raster_tiles(lsetup.planes, lbins, size, size), 10)
    plain_ms = _cuda_ms(lambda: rt.raster_tiles_plain(lsetup.planes, lbins, size, size), 1)
    kb = k1_bound("K1a", lsetup.planes, lbins, size * size)
    kernels["K1a shadow map"] = dict(max_abs_err=err_l, ms=ms, plain_ms=plain_ms, **kb)
    k1_line(f"K1a raster_tile, shadow map {size}x{size} over {lbins.ntx * lbins.nty} tiles", kb,
            ms, plain_ms)
    del r, res, setup, obins, shifted, lsetup, lbins
    torch.cuda.empty_cache()

    # filtered K2, on the raytraced path's second frame with test_alpha
    rt_cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                          raytraced=cfgmod.RaytracedSettings(test_alpha=True))
    r = Renderer(scene, rt_cfg, path="raytraced", device=dev)
    r.render_frame()
    res = r.fetch_resources("pfd", "BVH", "shade_tables", "TriRows")
    pfd, bvh, tables = res["pfd"], res["BVH"], res["shade_tables"]
    o, d = raytraced_path.primary_rays(pfd, HEIGHT, WIDTH)
    n = o.shape[0]
    p_tmax = torch.full((n,), raytraced_path.TMAX, device=dev)
    u = traverse.trace(bvh, None, o, d, raytraced_path.PRIMARY_TMIN, p_tmax)
    k = traverse.trace(bvh, None, o, d, raytraced_path.PRIMARY_TMIN, p_tmax, alpha_tables=tables)
    rejected = int((k.tri != u.tri).sum())
    pos = rt_shade.interpolate_hit_attributes(tables, res["TriRows"], k.tri, k.u,
                                              k.v)["position"].contiguous()
    s_dir = (-pfd.directional_light.direction[:3]).expand(pos.shape).contiguous()
    s_tmax = torch.where(k.hit, raytraced_path.TMAX, -1.0)
    us = traverse.trace(bvh, None, pos, s_dir, raytraced_path.SHADOW_TMIN, s_tmax, anyhit=True)
    ks = traverse.trace(bvh, None, pos, s_dir, raytraced_path.SHADOW_TMIN, s_tmax, anyhit=True,
                        alpha_tables=tables)
    # the bound's bytes add the tri_static rows (240 bytes) of the triangles
    # hit with or without the filter, each read at least once (a lower bound:
    # not the atlas quads)
    for name, (oo, dd, tmin, tmax, anyhit, kk, uu) in {
            "filtered closest-hit": (o, d, raytraced_path.PRIMARY_TMIN, p_tmax, False, k, u),
            "filtered any-hit": (pos, s_dir, raytraced_path.SHADOW_TMIN, s_tmax, True, ks, us),
    }.items():
        tris = torch.unique(torch.cat([kk.tri, uu.tri]))
        entry = k2_wave(bvh, f"raytraced frame's {'shadow' if anyhit else 'primary'}", oo, dd,
                        tmin, tmax, anyhit, tables, plain_timed=True,
                        extra_bytes=int((tris >= 0).sum()) * 240)
        u_ms = _cuda_ms(lambda: traverse.trace(bvh, None, oo, dd, tmin, tmax, anyhit=anyhit), 10)
        kernels[f"K2 {name}"] = entry
        print(f"K2 {name}: hits {int(kk.hit.sum())}, unfiltered {int(uu.hit.sum())}; unfiltered "
              f"kernel on the same rays {u_ms:.4f} ms")
    print(f"K2 filtered closest-hit differs from the unfiltered walk on {rejected} rays")
    _check(rejected > 0, "the alpha filter rejected no primary hit")
    del r, res, o, d, k, u, pos, s_dir, ks, us
    torch.cuda.empty_cache()

    # K2 on main path 7's wavefronts: the full frame at rt_scale=2, second
    # frame, rays from the RT Downsample Pass's depth and normals
    half_cfg = dataclasses.replace(full_cfg, hybrid=dataclasses.replace(full, rt_scale=2))
    r = Renderer(scene, half_cfg, device=dev)
    r.render_frame()
    res = r.fetch_resources("pfd", "BVH", hybrid_path.RT_DEPTH, hybrid_path.RT_NORMALS)
    rays = raygen.Wavefronts(res["pfd"], res[hybrid_path.RT_DEPTH], res[hybrid_path.RT_NORMALS],
                             half_cfg.hybrid, ao_rays=half_cfg.ao_rays)
    check_k2(res["BVH"], hybrid_wavefronts(rays, half_cfg.ao_rays), "rt_scale=2 frame's",
             timed=False)
    del r, res, rays

    # K1a and K2 any-hit on main path 6's inputs: the rayquery frame's
    # entry stream (every triangle, masked ones solid) and its shadow rays
    rq_cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    r = Renderer(scene, rq_cfg, path="rayquery", device=dev)
    r.render_frame()
    res = r.fetch_resources("scene", "pfd", "Clip", "BVH", "shade_tables", "TriRows")
    qsetup, qbins, _ = rt._opaque_stream(
        res["scene"], res["Clip"], WIDTH, HEIGHT,
        cull_backface=rq_cfg.raster_state.cull_mode == "back", alpha=False)
    vis = rt.raster_tiles(qsetup.planes, qbins, WIDTH, HEIGHT)
    err_q = k1_equal(f"K1a raster_tile, rayquery frame's entry stream "
                     f"({int(qbins.offsets[-1])} entries)", vis,
                     rt.raster_tiles_plain(qsetup.planes, qbins, WIDTH, HEIGHT))
    kernels["K1a"]["max_abs_err"] = max(kernels["K1a"]["max_abs_err"], err_q)
    attrs = shade.resolve_forward_attributes(res["scene"], res["shade_tables"], res["TriRows"],
                                             vis)
    origins = attrs["position"].reshape(-1, 3).contiguous()
    dirs = (-res["pfd"].directional_light.direction[:3]).expand(origins.shape).contiguous()
    tmax = torch.where(attrs["valid"].reshape(-1), rayquery_path.SHADOW_TMAX, -1.0)
    # the rayquery pass traces from tmin 0.1, the hybrid's shadow rays from 0.01
    k2_wave(res["BVH"], "rayquery frame's shadow", origins, dirs, rayquery_path.SHADOW_TMIN,
            tmax, True)
    del r, res, qsetup, qbins, vis, attrs, origins, dirs
    for name, err in k2_errs.items():
        kernels[name]["max_abs_err"] = err
    torch.cuda.empty_cache()

    # K3 on main path 10's inputs: cell 1's configuration with the shadow
    # grid, second frame's shadow wavefront, against its plain version and K2
    grid_cfg = RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="off", shadow_accel="grid")
    r = Renderer(scene, grid_cfg, device=dev)
    r.render_frame()
    # and on realglb's frame in the same configuration, with a grid built on
    # realglb; each unfiltered and filtered with the scene's alpha tables
    for wave_scene, label in ((scene, "path 10's second frame's shadow"),
                              (realglb, "realglb's grid frame's shadow")):
        # K3 is held to K2 any-hit on the f32 leaf-8 table (realglb's
        # default is bf16, whose rounded vertices answer differently)
        r = Renderer(wave_scene, dataclasses.replace(grid_cfg, bvh_dtype="f32", bvh_leaf_max=8),
                     device=dev)
        r.render_frame()
        res = r.fetch_resources("pfd", "ShadowGrid", "shade_tables", hybrid_path.DEPTH,
                                hybrid_path.NORMALS)
        sg = res["ShadowGrid"]
        rays = raygen.Wavefronts(res["pfd"], res[hybrid_path.DEPTH], res[hybrid_path.NORMALS],
                                 grid_cfg.hybrid, ao_rays=grid_cfg.ao_rays)
        entry = _k3_wave(r._get_bvh(), sg, rays.origin, rays.shadow_dir, raygen.SHADOW_TMIN,
                         rays.shadow_tmax, bound, label, tables=res["shade_tables"],
                         width=WIDTH, timed=True, other_k3=other_k3)
        if wave_scene is scene:
            kernels["K3"] = entry
        print(f"K3 grid of {wave_scene.name} (static, built at load): {_grid_bytes(sg)} | "
              f"card: {smi}")
        _check(int(sg.overflow) == 0, f"the shadow grid overflowed by {int(sg.overflow)} "
               "triangles")
        del r, res, rays, sg
        torch.cuda.empty_cache()
    _phase("kernels", t0)

    # ---- 5. GPU against CPU ------------------------------------------------------
    t0 = time.perf_counter()
    raster_ssr = cfgmod.HybridSettings(shadow_mode=cfgmod.ShadowMode.RASTERIZED,
                                       ao_mode=cfgmod.AmbientOcclusionMode.SSAO,
                                       reflection_mode=cfgmod.ReflectionMode.SSR)
    small_full = RenderConfig(width=320, height=180, alpha_raster="brute",
                              alpha_peel_rounds=4, ao_rays=2, hybrid=full)
    cornell, pica = procedural.cornell_box(), procedural.pica_proxy()
    # (name, path, config, frames, tolerance, share of pixels within it,
    # whether the stages are compared after the last frame)
    for name, path, small_cfg, frames, tol, share, stages in (
            ("RT shadows", "hybrid", RenderConfig(width=320, height=180, alpha_raster="off"),
             1, 1e-4, 0.999, False),
            ("full", "hybrid", small_full, 3, GPU_CPU_FULL_TOL, GPU_CPU_FULL_SHARE, False),
            ("forward coverage MSAA 4x", "forward",
             RenderConfig(width=320, height=180, shadow_map_size=512,
                          forward=cfgmod.ForwardSettings(msaa_samples=4)),
             3, GPU_CPU_RASTER_TOL, GPU_CPU_RASTER_SHARE, True),
            ("raster-mode hybrid + SSR", "hybrid",
             RenderConfig(width=320, height=180, shadow_map_size=512, alpha_raster="off",
                          hybrid=raster_ssr),
             3, GPU_CPU_RASTER_TOL, GPU_CPU_RASTER_SHARE, True),
            ("raytraced, test_alpha", "raytraced",
             RenderConfig(width=320, height=180,
                          raytraced=cfgmod.RaytracedSettings(test_alpha=True)),
             1, 1e-4, 0.999, False),
            ("rayquery", "rayquery", RenderConfig(width=320, height=180),
             1, GPU_CPU_RASTER_TOL, GPU_CPU_RASTER_SHARE, False),
            ("full at rt_scale=2", "hybrid",
             dataclasses.replace(small_full, hybrid=dataclasses.replace(full, rt_scale=2)),
             3, GPU_CPU_FULL_TOL, GPU_CPU_FULL_SHARE, False),
            ("realglb full", "hybrid", small_full, 3, GPU_CPU_FULL_TOL, GPU_CPU_FULL_SHARE,
             False),
            ("path 9, brute raster-mode hybrid", "hybrid",
             RenderConfig(width=320, height=180, shadow_map_size=512, alpha_raster="off",
                          raster="brute", hybrid=raster_hs),
             2, GPU_CPU_RASTER_TOL, GPU_CPU_RASTER_SHARE, False),
            ("path 10, RT shadows through the grid", "hybrid",
             RenderConfig(width=320, height=180, alpha_raster="off", shadow_accel="grid"),
             1, 1e-4, 0.999, False),
            ("path 11, animated pica", "hybrid",
             RenderConfig(width=320, height=180, animated=True, shadow_accel="grid", hybrid=full),
             3, GPU_CPU_FULL_TOL, GPU_CPU_FULL_SHARE, False),
            ("path 12, realglb full through the device LBVH", "hybrid", small_full, 3,
             GPU_CPU_FULL_TOL, GPU_CPU_FULL_SHARE, False),
            ("path 8 on a bf16 atlas", "hybrid", small_full, 2, GPU_CPU_FULL_TOL,
             GPU_CPU_FULL_SHARE, False)):
        frame_scene = {"realglb full": realglb, "path 9, brute raster-mode hybrid": cornell,
                       "path 11, animated pica": pica,
                       "path 12, realglb full through the device LBVH": realglb,
                       "path 8 on a bf16 atlas": realglb16}.get(name, scene)
        route = name.startswith("path 12")
        with _no_native(native_bridge) if route else contextlib.nullcontext():
            gr = Renderer(frame_scene, small_cfg, path=path, device=dev)
            cr = Renderer(frame_scene, small_cfg, path=path, device="cpu")
            if route:
                # each renderer builds its BVH8 by the no-native route: the
                # LBVH on its own device, collapsed in Python
                same_rows = torch.equal(gr._get_bvh().rows.cpu(), cr._get_bvh().rows)
        if route:
            print(f"path 12: the no-native route's BVH8 built with the card's LBVH equals the "
                  f"CPU's: {same_rows}")
            _check(same_rows, "the no-native route's BVH8 differs between the card and the CPU")
        for f in range(frames):
            if small_cfg.animated:
                for rr in (gr, cr):
                    rr.animate(procedural.animate_pica(frame_scene, f / 60.0))
            g, c = gr.render_frame().cpu(), cr.render_frame()
            d = (g - c).abs().amax(dim=0)
            shares = {t: float((d <= t).float().mean()) for t in (1e-5, 1e-4, 1e-3)}
            print(f"gpu vs cpu 320x180 {name}, frame {f}: share of pixels within "
                  + ", ".join(f"{t:g}: {s_:.6f}" for t, s_ in shares.items())
                  + f"; max |diff| {float(d.max()):.3g}")
            _check(bool(torch.isfinite(g).all()) and bool((d <= tol).float().mean() >= share),
                   f"gpu/cpu agreement of the {name} frame {f}: {shares}")
        if stages:
            _stage_agreement(gr, cr, path)
        del gr, cr
    _phase("gpu-cpu", t0)

    # ---- 6. main paths -------------------------------------------------------------
    counters = {
        "K1a": lambda: rt.raster_tiles.launches,
        "K1b": lambda: rt.raster_tiles_peel.launches,
        "K1c": lambda: rt.raster_tiles_compact.launches,
        "K1d": lambda: rt.raster_tiles_msaa.launches,
        **{_k2_name(kind, mode): (lambda m=_k2_name(kind, mode)[3:]: traverse.trace.launches[m])
           for kind in K2_KINDS
           for mode in ("any-hit", "closest-hit", "filtered any-hit", "filtered closest-hit")},
        "K3": lambda: shadowgrid.trace_shadow.launches,
        **{f"K4 {mode}": (lambda m=mode: traverse.trace_flat.launches[m])
           for mode in ("any-hit", "closest-hit")},
    }

    def drive(r, frames=10, before=None):
        """2 warm-up frames, then `frames` timed ones with every launch
        counter set to 0 just before them; returns (ms/frame, launches).
        before(r): called before every frame (the animated path's animate)."""
        for _ in range(2):
            if before is not None:
                before(r)
            frame = r.render_frame()
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(frame).all()), "warm-up frame not finite")
        rt.raster_tiles.launches = rt.raster_tiles_peel.launches = 0
        rt.raster_tiles_compact.launches = rt.raster_tiles_msaa.launches = 0
        traverse.trace.launches.clear()
        traverse.trace_flat.launches.clear()
        shadowgrid.trace_shadow.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(frames):
            if before is not None:
                before(r)
            frame = r.render_frame(sync=False)
        end.record()
        torch.cuda.synchronize()
        launches = {k: v() for k, v in counters.items()}
        _check(tuple(frame.shape) == (4, HEIGHT, WIDTH), f"frame shape {tuple(frame.shape)}")
        _check(bool(torch.isfinite(frame).all()), "main-path frame not finite")
        return start.elapsed_time(end) / frames, launches

    def dispatch(label, base, scene_, cfg_, path="hybrid", before=None, busy=False,
                 drove=None, pass_ms=()):
        """Phase 6d on one main path, its configuration on base's BVH8,
        shade tables and shadow grid: one eager frame's passes under
        set_sync_debug_mode("error"), where no pass may sync; a fused, a
        per_pass and an eager (graph.run) renderer in lockstep over 4
        frames, the temporal state carried, held bit-equal; capture seconds
        and graphs a frame (fused 1, per_pass one a pass); the device ms of
        each pass in `pass_ms`, its per_pass graph replayed alone between
        CUDA events (20 replays); ms/frame of fused and per_pass in turns
        (fused, per_pass, per_pass, fused; 10 frames each) beside 10 eager
        frames.  Launches per 10 frames: a captured frame's replays call no
        wrapper, so they add the counts each graph's capture recorded
        (runtime/dispatch.py); the eager frames' are the wrappers' own
        counts, measured here, and the fused and per_pass counts must
        equal them, as must drove, the counts drive() read on this path
        (the kernels line's launches).  With `busy`, the device busy share
        of a 5-frame window of each.  before(r, f) ahead of frame f (the
        animated path's transforms)."""
        step = before or (lambda r, f: None)

        def make(**kw):
            r = Renderer(scene_, cfg_, path=path, device=dev, **kw)
            r._bvh, r._shade_tables = base._bvh, base._shade_tables
            r._shadow_grid = base._shadow_grid
            return r

        rf, rp, reng = make(), make(dispatch="per_pass"), make()
        # the sync check on the second eager frame: the first may make a
        # device constant (utils/consts.py), a copy from the host once
        syncs = {}
        step(reng, 0)
        eager = [_eager_frame(reng)]
        step(reng, 1)
        eager.append(_eager_frame(reng, syncs))
        late = {n: s for n, s in syncs.items() if s is not None}
        print(f"dispatch {label}: eager frame under set_sync_debug_mode('error'): "
              f"{len(syncs)} passes, {len(late)} synced {late}")
        _check(not late, f"dispatch {label}: passes that sync: {late}")
        t = time.perf_counter()
        pre = rp.precompile_passes()
        pre_s = time.perf_counter() - t
        fused, per_pass = [], []
        for f in range(4):
            step(rf, f)
            fused.append(rf.render_frame())
            step(rp, f)
            per_pass.append(rp.render_frame())
            if f > 1:
                step(reng, f)
                eager.append(_eager_frame(reng))
        torch.cuda.synchronize()
        diffs = [(_max_abs(a - c), _max_abs(b - c), int((a != c).sum()), int((b != c).sum()))
                 for a, b, c in zip(fused, per_pass, eager)]
        same_f = all(torch.equal(a, c) for a, c in zip(fused, eager))
        same_p = all(torch.equal(b, c) for b, c in zip(per_pass, eager))
        cf, cp = rf._captured, rp._captured
        _check(cf.key == ("fused", path, cfg_) and cp.key == ("per_pass", path, cfg_)
               and cf.captured and cp.captured, f"dispatch {label}: a frame was not captured")
        order = reng.graph.find_execution_order()
        _check(cf.n_graphs == 1 and cp.n_graphs == len(order)
               and [s[0] for s in cp.segments] == order,
               f"dispatch {label}: fused {cf.n_graphs} graphs a frame, per_pass {cp.n_graphs} "
               f"for {len(order)} passes")
        in_graph = {}
        for name in pass_ms:
            g = cp.graphs[order.index(name)]
            in_graph[name] = _cuda_ms(g.replay, 20)
        if in_graph:
            print(f"dispatch {label}: device ms of a pass's per_pass graph replayed alone: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in in_graph.items()) + f" | card: {smi}")

        def window(r, first, n=10):
            torch.cuda.synchronize()
            rt.raster_tiles.launches = rt.raster_tiles_peel.launches = 0
            rt.raster_tiles_compact.launches = rt.raster_tiles_msaa.launches = 0
            traverse.trace.launches.clear()
            traverse.trace_flat.launches.clear()
            shadowgrid.trace_shadow.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                step(r, first + i)
                if r is reng:
                    _eager_frame(r)
                else:
                    r.render_frame(sync=False)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / n, {k: v() for k, v in counters.items() if v()}

        f1, lf = window(rf, 4)
        p1, lp = window(rp, 4)
        p2, _ = window(rp, 14)
        f2, _ = window(rf, 14)
        e_ms, le = window(reng, 4)
        print(f"dispatch {label}: fused: {cf.n_graphs} CUDA graph(s) replayed a frame, capture "
              f"{sum(cf.capture_s.values()):.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in cf.capture_s.items())}); "
              f"per_pass: {cp.n_graphs} graphs, precompile_passes {pre_s:.3f} s (eager frame "
              f"{pre['__trace_s__']:.3f} s, captures "
              f"{sum(v for k, v in pre.items() if not k.startswith('__')):.3f} s)")
        print(f"dispatch {label}: frames 1-4 against graph.run's: fused "
              f"{'bit-equal' if same_f else 'DIFFER'}, per_pass {'bit-equal' if same_p else 'DIFFER'} "
              f"(max |diff|, differing values per frame: "
              + "; ".join(f"{a:.3g}/{b:.3g}, {m}/{n}" for a, b, m, n in diffs) + ")")
        print(f"dispatch {label}: ms/frame in turns: fused {(f1 + f2) / 2:.3f} ({f1:.3f}, {f2:.3f}), "
              f"per_pass {(p1 + p2) / 2:.3f} ({p1:.3f}, {p2:.3f}), eager graph.run {e_ms:.3f} | "
              f"launches per 10 frames: fused {lf}, per_pass {lp}, eager (counted by the "
              f"wrappers) {le} | card: {smi}")
        _check(same_f and same_p, f"dispatch {label}: a captured frame differs from graph.run's")
        _check(lf == le and lp == le, f"dispatch {label}: launches per 10 frames fused {lf}, "
               f"per_pass {lp}, eager {le}: the counts added at replay are not the launches")
        if drove is not None:
            ran = {k: v for k, v in drove.items() if v}
            _check(ran == le, f"dispatch {label}: drive's launches {ran} != the eager frames' {le}")
        if busy:
            _profile(rf, f"{label} fused")
            _profile(rp, f"{label} per_pass")
        dispatch_ms[label] = ((f1 + f2) / 2, (p1 + p2) / 2, e_ms)
        del rf, rp, reng, fused, per_pass, eager

    dispatch_ms = {}
    t0 = time.perf_counter()
    # paths 1-11 and their recorded numbers are the SAH tree's: without the
    # native build the renderer would quietly take the LBVH's, so fail
    available = native_bridge.native_available()
    print(f"native_bridge.native_available() before main paths 1-11: {available}")
    _check(available, "the native build is not available: paths 1-11 would trace the LBVH's "
           "BVH8, not the SAH tree's")
    r = Renderer(scene, RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="off"), device=dev)
    ms_frame, launches = drive(r)
    ms_rt_shadows = ms_frame
    for name in ("K1a", "K2 any-hit"):
        _check(launches[name] >= 10, f"{name} launched {launches[name]} times in 10 frames")
    passes = r.time_passes(iters=5)
    shadow = r.fetch_resources(hybrid_path.RT_SHADOW_AO)[hybrid_path.RT_SHADOW_AO][0]
    print(f"main path 1: {scene.name} {WIDTH}x{HEIGHT} RT shadows, alpha off: "
          f"{ms_frame:.3f} ms/frame over 10 frames | launches {launches} | shadowed share "
          f"{float((shadow == 0.0).float().mean()):.4f}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    dispatch("path 1", r, scene, r.config, drove=launches)
    del r

    r = Renderer(scene, full_cfg, device=dev)
    ms_frame, launches = drive(r)
    ms_full = ms_frame
    for name, count in launches.items():
        _check(name in ("K1d", "K3") or name.startswith("K4") or "filtered" in name
               or "bf16-8" in name or "f32-12" in name or count >= 10,
               f"{name} launched {count} times in the full frame's 10 frames")
    passes = r.time_passes(iters=5)
    print(f"main path 2: {scene.name} {WIDTH}x{HEIGHT} full hybrid (RT shadows + RT AO + "
          f"RT reflections + SVGF, alpha_raster=brute, 4 peel rounds): {ms_frame:.3f} ms/frame "
          f"over 10 frames | launches {launches}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    _breakdown(r, full)
    if profile:
        _profile(r, "full")
    dispatch("path 2", r, scene, full_cfg, busy=True, drove=launches)
    del r

    r = Renderer(scene, fwd_cfg, path="forward", device=dev)
    ms_frame, launches3 = drive(r)
    for name in ("K1a", "K1b", "K1c", "K1d"):
        _check(launches3[name] >= 10,
               f"{name} launched {launches3[name]} times in the forward frame's 10 frames")
    passes = r.time_passes(iters=5)
    print(f"main path 3: {scene.name} {WIDTH}x{HEIGHT} forward, coverage MSAA 4x "
          f"(alpha_raster=brute, 4 peel rounds, {fwd_cfg.shadow_map_size}^2 shadow-map "
          f"prepass): {ms_frame:.3f} ms/frame over 10 frames | launches {launches3}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    if profile:
        _profile(r, "forward coverage-MSAA 4x")
    dispatch("path 3", r, scene, fwd_cfg, path="forward", drove=launches3)
    del r

    raster_cfg = RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="off", hybrid=raster_hs)
    r = Renderer(scene, raster_cfg, device=dev)
    ms_frame, launches4 = drive(r)
    _check(launches4["K1a"] >= 20,
           f"K1a launched {launches4['K1a']} times in the raster-mode frame's 10 frames")
    passes = r.time_passes(iters=5)
    print(f"main path 4: {scene.name} {WIDTH}x{HEIGHT} raster-mode hybrid (rasterized shadows "
          f"+ SSAO, alpha off): {ms_frame:.3f} ms/frame over 10 frames | launches {launches4}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    # 10 more frames with K1a's launches split by the image each rasters:
    # the G-buffer's and the Depth Prepass's shadow map
    # (eager frames: a captured frame's replays call no wrapper; phase 6d
    # holds the counts they add equal to 10 eager frames' own)
    k1a_split = _k1a_by_shape(rt, lambda: [_eager_frame(r) for _ in range(10)])
    map_shape = f"{raster_cfg.shadow_map_size}x{raster_cfg.shadow_map_size}"
    print(f"path 4's K1a launches in 10 more frames by image: {k1a_split}")
    _check(k1a_split == {f"{WIDTH}x{HEIGHT}": 10, map_shape: 10},
           f"path 4's K1a launches by image {k1a_split}: want 10 G-buffer and 10 prepass")
    if profile:
        _profile(r, "raster-mode hybrid")
    dispatch("path 4", r, scene, raster_cfg, drove=launches4)
    # the viewer's ssao_radius slider on path 4's frame (per_pass, as the
    # viewer renders; a config a value): a renderer keeps only the active
    # key's captured frame, so the memory the caching allocator holds stays
    # where the second value left it
    from vulkanhybridrenderer_tpu_torch.runtime.viewer import ViewerState

    state = ViewerState(scene, raster_cfg, "hybrid", device=dev)
    state.renderer._bvh, state.renderer._shade_tables = r._bvh, r._shade_tables
    reserved = []
    for i in range(8):
        state.set_param("ssao_radius", 0.3 + 0.05 * i)
        state.renderer.render_frame()
        reserved.append(torch.cuda.memory_reserved(dev))
    held = state.renderer._captured
    print(f"viewer slider: ssao_radius over 8 values on path 4 (per_pass, captured a value): "
          f"reserved MiB after each value {[round(x / 2**20, 1) for x in reserved]}; the "
          f"renderer holds the last value's frame only: "
          f"{held.key == ('per_pass', 'hybrid', state.renderer.config)} | card: {smi}")
    _check(max(reserved[2:]) <= reserved[1]
           and held.key == ("per_pass", "hybrid", state.renderer.config),
           f"dragging the viewer's slider grew the reserved memory: {reserved}")
    del state, held
    r.set_config(dataclasses.replace(raster_cfg, hybrid=raster_ssr))
    passes = r.time_passes(iters=1)
    print("per-pass ms with SSR (1 run after a warm-up): "
          + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    del r

    r = Renderer(scene, rt_cfg, path="raytraced", device=dev)
    ms_frame, launches5 = drive(r)
    for name in ("K2 filtered closest-hit", "K2 filtered any-hit"):
        _check(launches5[name] >= 10,
               f"{name} launched {launches5[name]} times in the raytraced frame's 10 frames")
    passes = r.time_passes(iters=5)
    print(f"main path 5: {scene.name} {WIDTH}x{HEIGHT} raytraced, test_alpha (primary and "
          f"shadow rays through the alpha filter): {ms_frame:.3f} ms/frame over 10 frames | "
          f"launches {launches5}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    if profile:
        _profile(r, "raytraced test_alpha")
    dispatch("path 5", r, scene, rt_cfg, path="raytraced", drove=launches5)
    del r

    r = Renderer(scene, rq_cfg, path="rayquery", device=dev)
    ms_frame, launches6 = drive(r)
    for name in ("K1a", "K2 any-hit"):
        _check(launches6[name] >= 10,
               f"{name} launched {launches6[name]} times in the rayquery frame's 10 frames")
    passes = r.time_passes(iters=5)
    print(f"main path 6: {scene.name} {WIDTH}x{HEIGHT} rayquery (K1a raster, one any-hit "
          f"shadow ray a pixel): {ms_frame:.3f} ms/frame over 10 frames | launches {launches6}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    if profile:
        _profile(r, "rayquery")
    dispatch("path 6", r, scene, rq_cfg, path="rayquery", drove=launches6)
    del r

    r = Renderer(scene, half_cfg, device=dev)
    ms_frame, launches7 = drive(r)
    for name in ("K2 any-hit", "K2 closest-hit"):
        _check(launches7[name] >= 10,
               f"{name} launched {launches7[name]} times in the rt_scale=2 frame's 10 frames")
    passes = r.time_passes(iters=5)
    print(f"main path 7: {scene.name} {WIDTH}x{HEIGHT} full hybrid at rt_scale=2 (rays, SVGF "
          f"at {WIDTH // 2}x{HEIGHT // 2}): {ms_frame:.3f} ms/frame over 10 frames, path 2 "
          f"{ms_full:.3f} | launches {launches7}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    if profile:
        _profile(r, "full at rt_scale=2")
    dispatch("path 7", r, scene, half_cfg, drove=launches7)
    del r

    # main path 8: bench.py's flagship as written, on realglb, with the
    # reference's default table rule (bvh_dtype="auto", bvh_leaf_max=0),
    # which must pick bf16 rows: the f32 leaf-8 table is past
    # TABLE_BUDGET_BYTES and the bf16 one is not
    r = Renderer(realglb, full_cfg, device=dev)
    b8_kind = r._get_bvh().kind
    f32_bytes = 512 * r._get_bvh().num_rows
    print(f"main path 8: RenderConfig(bvh_dtype={full_cfg.bvh_dtype!r}, "
          f"bvh_leaf_max={full_cfg.bvh_leaf_max}) on realglb: {b8_kind} rows; the f32 leaf-8 "
          f"table {f32_bytes} bytes, the bf16 one {r._get_bvh().table_bytes} bytes, budget "
          f"{bvh8_ops.TABLE_BUDGET_BYTES}")
    _check(b8_kind == "bf16-8", f"path 8's default config traced {b8_kind} rows, not bf16-8")
    ms_frame, launches8 = drive(r)
    ms_flagship = ms_frame
    for name in ("K1a", "K1b", "K1c", "K2 bf16-8 any-hit", "K2 bf16-8 closest-hit"):
        _check(launches8[name] >= 10,
               f"{name} launched {launches8[name]} times in the realglb frame's 10 frames")
    passes = r.time_passes(iters=5)
    print(f"main path 8: {realglb.name} ({r.buffers.num_triangles} triangles) {WIDTH}x{HEIGHT} "
          f"full hybrid, bench.py's flagship (RT shadows + RT AO + RT reflections + SVGF, "
          f"alpha_raster=brute, 4 peel rounds, {b8_kind} BVH8): {ms_frame:.3f} ms/frame over 10 "
          f"frames, path 2 (SponzaProxy) {ms_full:.3f} | launches {launches8}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    _breakdown(r, full)
    if profile:
        _profile(r, "realglb full")
    dispatch("path 8", r, realglb, full_cfg, busy=True, drove=launches8)
    del r

    # path 8 on the bf16 atlas (load_scene(atlas_dtype=torch.bfloat16)): the
    # same kernels, the samplers and the alpha filter reading the bf16
    # atlas through float32 tables
    r = Renderer(realglb16, full_cfg, device=dev)
    ms_frame, launches8a = drive(r)
    for name in ("K1a", "K1b", "K1c", "K2 bf16-8 any-hit", "K2 bf16-8 closest-hit"):
        _check(launches8a[name] >= 10,
               f"{name} launched {launches8a[name]} times in the bf16-atlas frame's 10 frames")
    print(f"main path 8 on a bf16 atlas ({r.buffers.atlas.data.dtype}, {atlas_bytes[1]} bytes "
          f"against {atlas_bytes[0]} in float32): {ms_frame:.3f} ms/frame over 10 frames, "
          f"path 8 {ms_flagship:.3f} | launches {launches8a}")
    del r

    # main path 9: cell 4's configuration (rasterized shadows + SSAO, alpha
    # off) with the brute reference rasterizer, its 4096^2 brute prepass
    # included, on cornell_box(): plain PyTorch, no hand kernel
    brute_cfg = RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="off", raster="brute",
                             hybrid=raster_hs)
    r = Renderer(cornell, brute_cfg, device=dev)
    ms_frame, launches9 = drive(r)
    _check(not any(launches9.values()), f"the brute path launched a hand kernel: {launches9}")
    passes = r.time_passes(iters=3)
    print(f"main path 9: {cornell.name} ({r.buffers.num_triangles} triangles) {WIDTH}x{HEIGHT} "
          f"raster-mode hybrid with raster=brute (rasterized shadows + SSAO, alpha off, "
          f"{brute_cfg.shadow_map_size}^2 brute prepass): {ms_frame:.3f} ms/frame over 10 frames "
          f"| launches {launches9}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    if profile:
        _profile(r, "brute raster-mode hybrid")
    res = r.fetch_resources("Clip", "LightClip", hybrid_path.DEPTH)
    setup = triangle_setup(res["Clip"], r.buffers.tri_vertex, WIDTH, HEIGHT)
    vb = rasterizer.rasterize(setup, WIDTH, HEIGHT)
    vk = rt.rasterize_scene(r.buffers, res["Clip"], WIDTH, HEIGHT, alpha=False)
    mism = float(((vb.tri_id != vk.tri_id) | ((vb.depth - vk.depth).abs() > 1e-6)).float().mean())
    le = rasterizer.rasterize(setup, WIDTH, HEIGHT, depth_compare="less_equal", depth_clear=1.0)
    both = (le.tri_id >= 0) & (vb.tri_id >= 0)
    nearer = bool(both.any()) and bool((le.depth[both] <= vb.depth[both] + 1e-6).all())
    brute_ms = _cuda_ms(lambda: rasterizer.rasterize(setup, WIDTH, HEIGHT), 3)
    prepass_ms = _cuda_ms(lambda: shadowmap.render_shadow_map(
        res["LightClip"], r.buffers.tri_vertex, brute_cfg.shadow_map_size, chunk=256), 3)
    print(f"path 9 brute visibility against the binned raster (K1a) of the same frame: tri id "
          f"or depth (> 1e-6) differ on {mism:.6f} of pixels (limit 0.002); the G-buffer's depth "
          f"is the brute raster's: {torch.equal(res[hybrid_path.DEPTH], vb.depth)}; less_equal / "
          f"clear 1.0 depth <= greater_equal depth wherever both cover ({int(both.sum())} "
          f"pixels): {nearer}; brute raster {WIDTH}x{HEIGHT} {brute_ms:.3f} ms, brute prepass "
          f"{brute_cfg.shadow_map_size}^2 {prepass_ms:.3f} ms")
    _check(mism <= 0.002 and nearer and torch.equal(res[hybrid_path.DEPTH], vb.depth),
           f"path 9's brute visibility: mismatch share {mism}, less_equal nearer {nearer}")
    dispatch("path 9", r, cornell, brute_cfg, drove=launches9, busy=True,
             pass_ms=("G-Buffer Pass", "Depth Prepass"))
    # check_binning: an entry cap far below cornell_box()'s entries raises at
    # the first frame; later frames are guarded on the device (NaN depth)
    real_cap = rt.default_e_cap
    rt.default_e_cap = lambda t, npix: 64
    try:
        rr = Renderer(cornell, RenderConfig(width=WIDTH, height=HEIGHT, alpha_raster="off"),
                      device=dev)
        try:
            rr.render_frame()
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        poisoned = bool(torch.isfinite(rr.render_frame()).all())
        nonfinite = rr.find_nonfinite_pass()
    finally:
        rt.default_e_cap = real_cap
    print(f"check_binning with an entry cap of 64 on {cornell.name}: the first frame raised "
          f"{raised!r}; the next frame finite {poisoned}, its first non-finite pass {nonfinite}")
    _check("entry overflow" in raised and not poisoned and nonfinite == "G-Buffer Pass",
           "check_binning or the overflow poison did not trip")
    del rr
    del r, res, setup, vb, vk, le

    # main path 10: cell 1's configuration with shadow_accel="grid": the
    # shadow rays through K3, no BVH in the graph
    r = Renderer(scene, grid_cfg, device=dev)
    ms_frame, launches10 = drive(r)
    _check(launches10["K3"] >= 10 and launches10["K1a"] >= 10,
           f"K3 / K1a launched {launches10['K3']} / {launches10['K1a']} times in path 10's frames")
    _check(not any(v for k, v in launches10.items() if k.startswith("K2")),
           f"path 10 launched K2: {launches10}")
    names = r.list_resources()
    _check("BVH" not in names and "ShadowGrid" in names, f"path 10's resources {names}")
    passes = r.time_passes(iters=5)
    print(f"main path 10: {scene.name} {WIDTH}x{HEIGHT} RT shadows through the shadow grid "
          f"(alpha off, shadow_accel=grid): {ms_frame:.3f} ms/frame over 10 frames, path 1 "
          f"{ms_rt_shadows:.3f} | launches {launches10}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    if profile:
        _profile(r, "RT shadows through the grid")
    idx = r.frame_index
    grid_frame = r.render_frame()
    r.frame_index = idx
    r.set_config(dataclasses.replace(grid_cfg, shadow_accel="bvh8"))
    bvh_frame = r.render_frame()
    print(f"path 10's frame equals path 1's of the same renderer state: "
          f"{torch.equal(grid_frame, bvh_frame)}")
    _check(torch.equal(grid_frame, bvh_frame), "path 10's frame differs from path 1's")
    dispatch("path 10", r, scene, grid_cfg, drove=launches10)
    del r, grid_frame, bvh_frame

    # main path 11: pica_proxy() animated, the full hybrid configuration with
    # shadow_accel="grid": BVH Refit and Shadow Grid Build every frame
    pica_cfg = RenderConfig(width=WIDTH, height=HEIGHT, animated=True, shadow_accel="grid",
                            hybrid=full)
    r = Renderer(pica, pica_cfg, device=dev)
    clock = iter(range(1 << 30))

    def animate(rr):
        rr.animate(procedural.animate_pica(pica, next(clock) / 60.0))

    ms_frame, launches11 = drive(r, before=animate)
    for name in ("K1a", "K2 any-hit", "K2 closest-hit", "K3"):
        _check(launches11[name] >= 10,
               f"{name} launched {launches11[name]} times in the animated frame's 10 frames")
    order = r.graph.find_execution_order()
    _check("BVH Refit" in order and "Shadow Grid Build" in order, f"path 11's passes {order}")
    passes = r.time_passes(iters=3)
    animate(r)
    a = r.render_frame()
    animate(r)
    moved = float((r.render_frame() - a).abs().max())
    print(f"main path 11: {pica.name} ({r.buffers.num_triangles} triangles) {WIDTH}x{HEIGHT} "
          f"animated full hybrid (RT shadows through the grid + RT AO + RT reflections + SVGF, "
          f"BVH Refit and Shadow Grid Build every frame): {ms_frame:.3f} ms/frame over 10 "
          f"frames | launches {launches11} | consecutive frames differ by up to {moved:.4f}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    _check(moved > 1e-3, "path 11's consecutive frames are equal")
    refit, moved_tris = r.fetch_resource("BVH", "WorldTris")
    print("path 11: " + _validate(bvh8_ops, refit, moved_tris, "the BVH Refit pass's refit8 "
                                  "output after its last frame"))
    if profile:
        _profile(r, "animated pica", before=animate)
    dispatch("path 11", r, pica, pica_cfg,
             before=lambda rr, f: rr.animate(procedural.animate_pica(pica, f / 60.0)),
             drove=launches11, busy=True, pass_ms=("Shadow Grid Build", "Raytrace Pass"))
    del r, a
    _animated_wavefronts(pica, pica_cfg, dev, bound, other_k3)

    # main path 12: path 8's flagship frame through the renderer's own route
    # without a native build (the reference's _get_bvh, runtime/renderer.py:
    # 200-203): native_available() returns False (and the native library
    # cannot be loaded) while the renderer builds its BVH8, the device LBVH
    # collapsed in Python; its rows against the native collapse of the same
    # LBVH (_lbvh8, the yardstick)
    r, route8, lbvh, world_tris, lbvh8 = _route_renderer(realglb, full_cfg, dev)
    kind12 = route8.kind
    ms_frame, launches12 = drive(r)
    for name in ("K1a", "K1b", "K1c", _k2_name(kind12, "any-hit"),
                 _k2_name(kind12, "closest-hit")):
        _check(launches12[name] >= 10,
               f"{name} launched {launches12[name]} times in path 12's 10 frames")
    _check(r._get_bvh() is route8, "path 12 did not trace the route's BVH8")
    passes = r.time_passes(iters=5)
    print(f"main path 12: {realglb.name} {WIDTH}x{HEIGHT} full hybrid through the no-native "
          f"route, K2 over the device LBVH's BVH8 ({kind12} rows, {r._bvh.num_rows} rows, depth "
          f"bound {r._bvh.depth}): {ms_frame:.3f} "
          f"ms/frame over 10 frames, path 8 (SAH BVH8) {ms_flagship:.3f} | launches {launches12}")
    print("per-pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    lb, sa = "realglb full frame's (LBVH BVH8) ", "realglb full frame's "
    print("K2 rows a live ray on realglb's second frame (phase 4), the LBVH's BVH8 / path 8's "
          "SAH BVH8: " + ", ".join(f"{w} {rows_live[lb + w]:.2f} / {rows_live[sa + w]:.2f}"
                                   for w in ("shadow", "AO", "reflection")))
    _profile(r, "path 12", frames=3)
    # K4's path: the frame's wavefronts through trace() with the binary
    # LBVH and its triangles, counters set to 0 just before, read just after;
    # K2 over the LBVH's own BVH8 on the same rays beside it
    r.render_frame()
    res = r.fetch_resources("pfd", hybrid_path.DEPTH, hybrid_path.NORMALS)
    rays = raygen.Wavefronts(res["pfd"], res[hybrid_path.DEPTH], res[hybrid_path.NORMALS], full,
                             ao_rays=full_cfg.ao_rays)
    waves = hybrid_wavefronts(rays, full_cfg.ao_rays)
    lbvh_tables = traverse.pack_flat(lbvh, world_tris)  # once per tree
    traverse.trace_flat.launches.clear()
    flat = {w: traverse.trace(lbvh_tables, None, o, d, raygen.SHADOW_TMIN, tmax, anyhit=ah)
            for w, (o, d, tmax, ah) in waves.items()}
    torch.cuda.synchronize()
    k4_launches = dict(traverse.trace_flat.launches)
    same_tree = {w: int((flat[w].hit != traverse.trace(r._bvh, None, o, d, raygen.SHADOW_TMIN, tmax,
                                                       anyhit=ah).hit).sum())
                 for w, (o, d, tmax, ah) in waves.items()}
    print(f"K4 path: path 12's frame's wavefronts through trace(pack_flat(LBVH, ...)): launches "
          f"{k4_launches}; hit flags differing from K2 over the LBVH's BVH8 {same_tree}")
    _check(k4_launches.get("any-hit", 0) >= 2 and k4_launches.get("closest-hit", 0) >= 1,
           f"K4's path launched it {k4_launches}")
    # the reference's own positional calls on the card: trace(bvh, tri_verts,
    # origin, direction, tmin, tmax) on the binary LBVH (packed from tri_verts
    # on the call) and on its BVH8 (tri_verts unread), each against the
    # keyword form; graph.time_passes(res, iters=2) without a device
    o, d, tmax, _ = waves["reflection"]
    pos_same = {}
    for name, tree, form in (("binary LBVH", lbvh, lbvh_tables), ("BVH8", r._bvh, r._bvh)):
        pos = traverse.trace(tree, world_tris, o, d, raygen.SHADOW_TMIN, tmax)
        kw = traverse.trace(form, None, o, d, raygen.SHADOW_TMIN, tmax, anyhit=False)
        pos_same[name] = all(torch.equal(getattr(pos, f), getattr(kw, f))
                         for f in ("t", "tri", "u", "v"))
    timed = r.graph.time_passes(r._resources(r._make_pfd()), iters=2)
    print(f"reference positional calls on the card: trace(bvh, tri_verts, o, d, tmin, tmax) "
          f"equal to the keyword form on realglb's reflection rays {pos_same}; "
          f"graph.time_passes(res, iters=2): {len(timed)} passes, "
          f"{sum(timed.values()):.3f} ms | card: {smi}")
    _check(all(pos_same.values()) and list(timed) == r.graph.find_execution_order(),
           f"the reference's positional calls: {pos_same}, {list(timed)}")
    dispatch("path 12", r, realglb, full_cfg, drove=launches12)
    del r, res, rays, waves, flat, lbvh, lbvh_tables, world_tris, lbvh8, route8

    # main path 14: the table kinds path 8 does not trace, through the entry
    # points on realglb: the full frame with bvh_leaf_max=12 (f32 leaf-12
    # rows), and the raytraced frame with test_alpha (filtered primary and
    # shadow rays) on the default table, bf16, and with bvh_leaf_max=12
    launches14 = {}
    for label, path, cfg14, want, modes in (
            ("full hybrid, bvh_leaf_max=12", "hybrid",
             dataclasses.replace(full_cfg, bvh_leaf_max=12), "f32-12", ("any-hit", "closest-hit")),
            ("raytraced, test_alpha", "raytraced", rt_cfg, "bf16-8",
             ("filtered any-hit", "filtered closest-hit")),
            ("raytraced, test_alpha, bvh_leaf_max=12", "raytraced",
             dataclasses.replace(rt_cfg, bvh_leaf_max=12), "f32-12",
             ("filtered any-hit", "filtered closest-hit"))):
        r = Renderer(realglb, cfg14, path=path, device=dev)
        kind14 = r._get_bvh().kind
        _check(kind14 == want, f"path 14 ({label}) traced {kind14} rows, not {want}")
        ms_frame, counts = drive(r)
        for mode in modes:
            name = _k2_name(kind14, mode)
            _check(counts[name] >= 10, f"{name} launched {counts[name]} times in path 14's "
                   f"{label} frames")
            launches14[name] = counts[name]
        print(f"main path 14: {realglb.name} {WIDTH}x{HEIGHT} {label}: {kind14} rows "
              f"({r._bvh.num_rows} rows, {r._bvh.table_bytes} bytes): {ms_frame:.3f} ms/frame "
              f"over 10 frames | launches { {k: v for k, v in counts.items() if v} }")
        dispatch(f"path 14 ({label})", r, realglb, cfg14, path=path, drove=counts)
        del r
    print(f"card: {smi}")
    _phase("main", t0)

    # ---- 6b. the Renderer's surface at 320x180 on the card -------------------------
    t0 = time.perf_counter()
    r = Renderer(realglb, small_full, device=dev)
    names = r.list_resources()
    externals = r._resources(r._make_pfd())
    produced = set(r.graph.run(externals)) - set(externals)
    _check(len(names) == len(set(names)) and set(names) == produced,
           f"list_resources {names} differs from the graph's outputs {sorted(produced)}")
    dump = build.BUILD_DIR / "chip_smoke_albedo.png"
    albedo = r.debug_dump("Albedo", dump, srgb=True)
    dumped = png.decode_png(dump.read_bytes())
    _check(np.array_equal(dumped[..., :3], to_uint8_image(albedo)),
           "debug_dump's PNG differs from to_uint8_image")
    bad = r.find_nonfinite_pass()
    _check(bad is None, f"find_nonfinite_pass named {bad!r} on a clean frame")
    for _ in range(3):
        r.render_frame()
    r.time_passes(iters=1)
    torch.cuda.synchronize()
    table = r.stats.table()
    _check(r.stats.frame_ms is not None, "no frame time reached stats")
    trace_dir = build.BUILD_DIR / "chip_smoke_trace"
    _check(r.profile(trace_dir, frames=2) == trace_dir, "profile returned another directory")
    trace = trace_dir / f"{r.path_name}_frame{r.frame_index}.json"
    _check(trace.is_file() and trace.stat().st_size > 0, f"profile wrote no trace at {trace}")
    print(f"surface: {len(names)} resources listed, the graph's outputs; debug_dump Albedo "
          f"{dumped.shape} PNG decodes to to_uint8_image; find_nonfinite_pass None; profile "
          f"trace {trace.name} ({trace.stat().st_size} bytes)\n{table}")
    del r
    _phase("surface", t0)

    # ---- 6c. the frame over a mesh ---------------------------------------------------
    t0 = time.perf_counter()
    kernels.update(_mesh_phase(realglb, full_cfg, raster_cfg, dev, drive, k1_equal, k1_bound,
                               k2_wave, smi, launches))
    timed_counts, realglb_bvh = _mesh_captured_phase(realglb, full_cfg, raster_cfg, pica,
                                                     pica_cfg, dev, smi)
    mesh_entries, mesh_launches = _mesh_path_kernels(realglb, realglb_bvh, dev, k1_equal,
                                                     k1_bound, k2_wave, timed_counts)
    kernels.update(mesh_entries)
    launches.update(mesh_launches)
    _phase("mesh", t0)

    # ---- 7. the row-gather probe ---------------------------------------------------
    t0 = time.perf_counter()
    probe.launches.clear()
    probe_res = probe.run(parent=None if other_probe is None
                          else _parent_walk(other_probe, build, dev))
    print(f"probe launches: {dict(probe.launches)}")
    for name in [*probe.REPLACES, "read-rate", "latency", "stage"]:
        _check(probe.launches[name] >= 1, f"probe kernel {name} never launched")
    _phase("probe", t0)

    # each kernel's launches from the path that introduced it: the full
    # frame's for K1a, K1b, K1c and K2, the forward frame's for K1d, the
    # raytraced frame's for the filtered K2, the grid frame's (path 10) for
    # K3, K4's path (path 12's wavefronts through the LBVH) for K4
    launches["K1d"] = launches3["K1d"]
    launches["K3"] = launches10["K3"]
    # the shadow map's K1a: the forward frame's only K1a launch is its depth
    # prepass.  The raster-mode frame's K1a count holds its G-buffer's and
    # its prepass's together; the counters do not tell them apart.
    launches["K1a shadow map"] = launches3["K1a"]
    print(f"K1a shadow map launches per 10 frames: cell 3 {launches3['K1a']}; cell 4 "
          f"{launches4['K1a']} in its timed frames, by image in 10 more: {k1a_split}")
    for name in ("K2 filtered closest-hit", "K2 filtered any-hit"):
        launches[name] = launches5[name]
    # K2's other row kinds: path 8's bf16 walks, path 14's others
    for mode in ("any-hit", "closest-hit"):
        launches[_k2_name("bf16-8", mode)] = launches8[_k2_name("bf16-8", mode)]
    launches.update(launches14)
    for mode in ("any-hit", "closest-hit"):
        launches[f"K4 {mode}"] = k4_launches[mode]

    entries = []
    sources = {"K1": ("raster_tile.cu", "vulkanhybridrenderer_tpu/ops/rasterizer_tiled.py:567"),
               "K2": ("bvh8_trace.cu", "vulkanhybridrenderer_tpu/ops/traverse.py:135"),
               "K3": ("shadow_grid.cu", "vulkanhybridrenderer_tpu/ops/shadowgrid.py:229"),
               "K4": ("bvh_flat_trace.cu", "vulkanhybridrenderer_tpu/ops/traverse.py:697")}
    for name, k in kernels.items():
        src, replaces = sources[name[:2]]
        entries.append(dict(
            name=name, route="cuda", source=f"vulkanhybridrenderer_tpu_torch/csrc/{src}",
            replaces=replaces, launches=launches[name], **k,
            # no single PyTorch call rasters binned triangles, walks a BVH
            # or a grid of triangles
            library_ms=None))
    entries.append(dict(name="toy x * 2", route="cuda",
                        source="vulkanhybridrenderer_tpu_torch/csrc/toy_scale.cu",
                        replaces="tests/test_compile_cache.py:33", launches=toy_launches,
                        **kernels_toy))
    for name in probe.REPLACES:
        # no single PyTorch call walks a chain; gather16's is img[idx]
        k = {key: probe_res[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms")}
        entries.append(dict(name=f"probe {name}", route="cuda",
                            source="vulkanhybridrenderer_tpu_torch/csrc/gather_probe.cu",
                            replaces=probe.REPLACES[name], launches=probe.launches[name], **k))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def _eager_frame(r, syncs=None):
    """One frame of renderer r through its graph's passes eagerly (graph.run,
    no capture), advancing its frame index and temporal state as
    render_frame does; returns RENDER_OUTPUT.  With `syncs` (a dict), each
    pass runs under torch.cuda.set_sync_debug_mode("error") and syncs[pass]
    receives the error of the first synchronizing call it made (the pass is
    then run again without the mode, to finish the frame), else None."""
    from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT

    res = r._resources(r._make_pfd())
    for name in r.graph.find_execution_order():
        p = r.graph.passes[name]
        if syncs is None:
            produced = p.fn(res)
        else:
            syncs[name] = None
            torch.cuda.set_sync_debug_mode("error")
            try:
                produced = p.fn(res)
            except RuntimeError as e:
                if "synchronizing" not in str(e):
                    raise
                syncs[name] = str(e).splitlines()[0]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if syncs[name] is not None:
                produced = p.fn(res)
        res.update({k: produced[k] for k in p.outputs})
    if r.path.uses_temporal_state:
        r.temporal_state = res["TemporalStateOut"]
    r.frame_index += 1
    return res[RENDER_OUTPUT]


def _k1a_by_shape(rt, run) -> dict:
    """run() with rasterizer_tiled.launch wrapped: K1a's launches counted by
    the "WxH" image each rasters (the wrappers' own counters untouched)."""
    real, shapes = rt.launch, collections.Counter()

    def counted(mode, planes, bins, width, height, *args, **kwargs):
        real(mode, planes, bins, width, height, *args, **kwargs)
        if mode == "K1a":
            shapes[f"{width}x{height}"] += 1

    rt.launch = counted
    try:
        run()
    finally:
        rt.launch = real
    return dict(shapes)


def _mesh_phase(realglb, cfg, raster_cfg, dev, drive, k1_equal, k1_bound, k2_wave, smi,
                launches):
    """Phase 6c: main path 8 (cfg on realglb) and cell 4's raster mode
    (raster_cfg on realglb) over a mesh: make_mesh() where the machine has
    two cards or more, else a virtual mesh of 4 shards on `dev`.  (a) The
    sort-last raster of the frame's clip-space vertices equal to
    rasterize_scene on every pixel, K1a launched once per shard; (b) path
    8's frames 1 and 2 equal to the single-device renderer's (torch.equal),
    K1a launched once per shard and frame, K2 once per slab and wavefront;
    (c) ms/frame of both renderers in turns (single, mesh, mesh, single),
    by CUDA events on the primary's stream, which render_frame makes wait
    for every device of the mesh; (d) _mesh_frame's checks and times of
    path 8, then of the raster mode.  Then K1a on shard 0's triangles and
    K2 on slab 0's AO and reflection rays against their plain versions,
    with their times and bounds: the JSON line's mesh entries, whose
    launches are path 8's timed mesh frames'.  `launches` receives those
    counts."""
    from vulkanhybridrenderer_tpu_torch.core.config import ReflectionMode
    from vulkanhybridrenderer_tpu_torch.models import hybrid as hybrid_path
    from vulkanhybridrenderer_tpu_torch.ops import raygen, rasterizer_tiled as rt, traverse
    from vulkanhybridrenderer_tpu_torch.ops.rasterizer import triangle_setup
    from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer

    n_cards = torch.cuda.device_count()
    mesh = pmesh.make_mesh() if n_cards >= 2 else pmesh.make_mesh([dev] * 4)
    n = mesh.devices.size
    print(f"mesh: {'real' if n_cards >= 2 else 'virtual'}, {n} shards on "
          f"{[str(d) for d in mesh.devices]} ({n_cards} card(s) on this machine)")
    _check(HEIGHT % n == 0, f"{HEIGHT} rows do not divide over the mesh's {n} shards")

    def sync_all():
        for d in mesh.distinct():
            torch.cuda.synchronize(d)

    def host_ms(fn, iters):
        fn()
        sync_all()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        sync_all()
        return (time.perf_counter() - t) * 1e3 / iters

    single = Renderer(realglb, cfg, device=dev)
    meshed = Renderer(realglb, cfg, mesh=mesh)
    _check(meshed.device == dev, f"the mesh renderer's device {meshed.device}")
    single.render_frame()
    meshed.render_frame()
    res = single.fetch_resources("Clip", "shade_tables", "BVH", "pfd", hybrid_path.DEPTH,
                                 hybrid_path.NORMALS)
    b, clip, tables = single.buffers, res["Clip"], res["shade_tables"]

    # (a) the sort-last raster against the single-device raster
    one = rt.rasterize_scene(b, clip, WIDTH, HEIGHT, tables=tables)
    rt.raster_tiles.launches = 0
    sharded = pmesh.rasterize_scene_sharded(b, clip, WIDTH, HEIGHT, mesh, tables=tables)
    sync_all()
    k1a_calls = rt.raster_tiles.launches
    k1_equal(f"mesh: sort-last raster of realglb's frame over {n} shards against rasterize_scene",
             sharded, one)
    _check(k1a_calls == n, f"the sort-last raster launched K1a {k1a_calls} times, not {n}")
    ms_sharded = host_ms(lambda: pmesh.rasterize_scene_sharded(b, clip, WIDTH, HEIGHT, mesh,
                                                               tables=tables), 5)
    ms_one = host_ms(lambda: rt.rasterize_scene(b, clip, WIDTH, HEIGHT, tables=tables), 5)
    print(f"mesh: sort-last raster {ms_sharded:.3f} ms, rasterize_scene {ms_one:.3f} ms (host "
          f"clock around synchronized runs, 5 each; K1a launched {k1a_calls} times a raster)")

    # (b) frames 1 and 2 over the mesh against the single-device renderer's
    frames = [single.render_frame() for _ in range(2)]
    rt.raster_tiles.launches = rt.raster_tiles_peel.launches = rt.raster_tiles_compact.launches = 0
    traverse.trace.launches.clear()
    mframes = [meshed.render_frame() for _ in range(2)]
    sync_all()
    kind = res["BVH"].kind
    any_hit, closest = _k2_name(kind, "any-hit"), _k2_name(kind, "closest-hit")
    got = {"K1a": rt.raster_tiles.launches, "K1b": rt.raster_tiles_peel.launches,
           any_hit: traverse.trace.launches[any_hit[3:]],
           closest: traverse.trace.launches[closest[3:]]}
    for i, (a, m) in enumerate(zip(frames, mframes), start=1):
        eq = torch.equal(a, m)
        print(f"mesh: path 8's frame {i} over the mesh against the single-device frame: "
              + ("equal on every pixel" if eq else
                 f"DIFFERS on {int((a != m).any(dim=0).sum())} pixels (max {_max_abs(a - m):.3g})"))
        _check(eq, f"path 8's frame {i} over the mesh differs from the single-device frame")
    print(f"mesh: launches in frames 1-2 {got} ({kind} rows)")
    _check(got["K1a"] == 2 * n and got[any_hit] == 4 * n and got[closest] == 2 * n
           and got["K1b"] >= 2, f"frames 1-2 over the mesh launched {got}: want K1a {2 * n} "
           f"(a shard a frame), K2 any-hit {4 * n} and closest-hit {2 * n} (a slab a wavefront)")
    del frames, mframes

    # (c) ms/frame in turns
    ms = {"single": [], "mesh": []}
    for which in ("single", "mesh", "mesh", "single"):
        ms_frame, counts = drive(single if which == "single" else meshed)
        ms[which].append(ms_frame)
        if which == "mesh":
            mesh_launches = counts
    _check(mesh_launches["K1a"] == 10 * n and mesh_launches[closest] == 10 * n,
           f"the timed mesh frames launched {mesh_launches}")
    print(f"mesh ms/frame (path 8, realglb {WIDTH}x{HEIGHT}, 10 frames each, in turns single, "
          f"mesh, mesh, single): single {ms['single'][0]:.3f} / {ms['single'][1]:.3f}, "
          f"{'real' if n_cards >= 2 else 'virtual'} mesh of {n} {ms['mesh'][0]:.3f} / "
          f"{ms['mesh'][1]:.3f} | launches {mesh_launches} | card: {smi}")

    # (d) path 8, then cell 4's raster mode: sync-free frame, bytes, per-shard
    # pass times
    _mesh_frame("path 8", single, meshed, mesh, sync_all, smi)
    raster_one = Renderer(realglb, raster_cfg, device=dev)
    raster_mesh = Renderer(realglb, raster_cfg, mesh=mesh)
    for i in range(3):
        a, m = raster_one.render_frame(), raster_mesh.render_frame()
        if i:
            eq = torch.equal(a, m)
            print(f"mesh: cell 4's frame {i} over the mesh against the single-device frame: "
                  + ("equal on every pixel" if eq else f"DIFFERS on "
                     f"{int((a != m).any(dim=0).sum())} pixels (max {_max_abs(a - m):.3g})"))
            _check(eq, f"cell 4's frame {i} over the mesh differs from the single-device frame")
    del a, m
    _mesh_frame("cell 4", raster_one, raster_mesh, mesh, sync_all, smi)
    ms = {"single": [], "mesh": []}
    for which in ("single", "mesh", "mesh", "single"):
        ms[which].append(drive(raster_one if which == "single" else raster_mesh)[0])
    print(f"mesh ms/frame (cell 4, realglb {WIDTH}x{HEIGHT}, 10 frames each, in turns single, "
          f"mesh, mesh, single): single {ms['single'][0]:.3f} / {ms['single'][1]:.3f}, "
          f"{'real' if n_cards >= 2 else 'virtual'} mesh of {n} {ms['mesh'][0]:.3f} / "
          f"{ms['mesh'][1]:.3f} | card: {smi}")
    del raster_one, raster_mesh
    # SSR's march reads any row of four whole images: its frame 1 too, from
    # two new renderers in lockstep (the frame index seeds SSAO's samples)
    ssr_cfg = dataclasses.replace(raster_cfg, hybrid=dataclasses.replace(
        raster_cfg.hybrid, reflection_mode=ReflectionMode.SSR))
    pair = (Renderer(realglb, ssr_cfg, device=dev), Renderer(realglb, ssr_cfg, mesh=mesh))
    a, m = [[r.render_frame() for _ in range(2)][1] for r in pair]
    eq = torch.equal(a, m)
    print("mesh: cell 4 with SSR, frame 1 over the mesh against the single-device frame: "
          + ("equal on every pixel" if eq else f"DIFFERS on {int((a != m).any(dim=0).sum())} "
             f"pixels (max {_max_abs(a - m):.3g})"))
    _check(eq, "cell 4 with SSR over the mesh differs from the single-device frame")
    del a, m, pair

    # the mesh's kernel instances against their plain versions: K1a on shard
    # 0's triangles (the whole frame), K2 on slab 0's AO and reflection rays
    entries = {}
    setup = triangle_setup(clip, b.tri_vertex, WIDTH, HEIGHT)
    per = -(-setup.planes.shape[0] // n)
    sub = type(setup)(**{f: getattr(setup, f)[:per].to(mesh.devices[0])
                         for f in ("planes", "sx", "sy", "bbox", "w_any", "front", "valid")})
    opaque, _ = rt.opaque_include(b, True)
    bins = rt.bin_triangles(sub, WIDTH, HEIGHT,
                            include=None if opaque is None else opaque[:per])
    err = k1_equal(f"mesh: K1a on shard 0's {per} triangles",
                   rt.raster_tiles(sub.planes, bins, WIDTH, HEIGHT),
                   rt.raster_tiles_plain(sub.planes, bins, WIDTH, HEIGHT))
    kb = k1_bound("K1a", sub.planes, bins, WIDTH * HEIGHT)
    k_ms = _cuda_ms(lambda: rt.raster_tiles(sub.planes, bins, WIDTH, HEIGHT), 20)
    p_ms = _cuda_ms(lambda: rt.raster_tiles_plain(sub.planes, bins, WIDTH, HEIGHT), 2)
    entries["K1a mesh shard"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                     bound_ms=kb["bound_ms"], bound_by=kb["bound_by"])
    print(f"mesh: K1a on shard 0: {kb['entries']} entries, kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {kb['bound_ms']:.4f} ms (set by {kb['bound_by']})")
    rays = raygen.Wavefronts(res["pfd"], res[hybrid_path.DEPTH], res[hybrid_path.NORMALS],
                             cfg.hybrid, ao_rays=cfg.ao_rays)
    slab = slice(0, rays.origin.shape[0] // n)
    k = cfg.ao_rays
    ao = (rays.origin[slab].repeat(k, 1),
          rays.ao_dir.reshape(k, -1, 3)[:, slab].reshape(-1, 3), rays.ao_tmax[slab].repeat(k))
    for name, (o, d, tmax), anyhit in (
            (f"{any_hit} mesh slab", ao, True),
            (f"{closest} mesh slab", (rays.origin[slab], rays.refl_dir[slab],
                                      rays.refl_tmax[slab]), False)):
        entries[name] = k2_wave(res["BVH"], f"mesh slab 0 of {n} {'AO' if anyhit else 'reflection'}",
                                o.contiguous(), d.contiguous(), raygen.SHADOW_TMIN,
                                tmax.contiguous(), anyhit, plain_timed=True)
    launches.update({"K1a mesh shard": mesh_launches["K1a"],
                     f"{any_hit} mesh slab": mesh_launches[any_hit],
                     f"{closest} mesh slab": mesh_launches[closest]})
    del single, meshed
    torch.cuda.empty_cache()
    return entries


def _eager_mesh_frame(r):
    """One eager frame of a mesh renderer r on the card (the mesh frame
    function, run_sharded, not its captured frame), advancing r as
    render_frame does; the primary's current stream then waits for every
    card's.  Returns RENDER_OUTPUT on the primary."""
    from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT

    res = r._frame_fn()(r._resources(r._make_pfd()))
    if r.path.uses_temporal_state:
        r.temporal_state = res["TemporalStateOut"]
    r.frame_index += 1
    main = torch.cuda.current_stream(r.device)
    for d in r.mesh.distinct()[1:]:
        main.wait_stream(torch.cuda.current_stream(d))
    return res[RENDER_OUTPUT]


#: the counters of runtime/dispatch.counters(mesh), by name
_COUNTER_NAMES = ("K1a", "K1b", "K1c", "K1d")


def _named_counts(d: list) -> dict:
    """A runtime/dispatch.delta over counters(mesh) by name: K1a-K1d, K2's
    modes as _k2_name names them ("K2 <mode>", the kind in the mode), and
    the mesh's moved bytes by kind."""
    out = dict(zip(_COUNTER_NAMES, d[:4]))
    out.update({f"K2 {mode}": v for mode, v in d[4].items() if v})
    out["moved"] = dict(d[-1])
    return out


def _mesh_captured_phase(realglb, cfg, raster_cfg, pica, pica_cfg, dev, smi):
    """Phase 6c (e): the mesh frame captured (runtime/dispatch.py: one
    graph a frame, fused, or one a pass, per_pass, each spanning the mesh's
    cards) against the eager mesh frame (run_sharded) and one card's fused
    frame, on make_mesh() where the machine has two cards or more, else a
    virtual mesh of 4 on `dev`: path 8, cell 4 with and without SSR, the
    full frame at rt_scale=2 (on realglb) and path 11 (pica_proxy animated
    a frame); then the other paths, row-sharded as the hybrid, on realglb:
    the raytraced frame with test_alpha (cell 14's, on the bf16 table), the
    rayquery frame (cell 6's configuration), the forward frame at one
    sample and at supersample 4 (a 3840x2160 raster).  Over frames 0-3,
    the camera moving before each and the temporal state carried, every
    frame equal (torch.equal); fused captures at frame 1 and per_pass at
    frame 0 (auto_precompile: precompile_passes over the mesh), the warm-up
    and the captures under set_sync_debug_mode("error"); a replayed frame's
    launch counts and Mesh.moved bytes equal to the eager frame's; the
    graphs a frame and capture seconds printed.  The hybrid cases must
    exchange halos or gathers, the other paths none; their eager frames
    must launch K1a once per shard and image rastered and K2 once per slab
    and wavefront, and each pass's device ms on each shard is printed
    (parallel/mesh.ShardClock).  Then ms/frame in turns (CUDA events on the
    primary's stream): the hybrid cases but SSR's one card fused, mesh
    eager, mesh captured, mesh captured, mesh eager, one card fused (10
    frames each, 5 eager); the other paths one card fused, mesh captured,
    mesh captured, one card fused.  Returns, for the other paths, the
    counts of the first turn's 10 captured frames (_named_counts) and the
    BVH8 they traced."""
    import copy

    from vulkanhybridrenderer_tpu_torch.core import config as cfgmod
    from vulkanhybridrenderer_tpu_torch.core.config import ReflectionMode, RenderConfig
    from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
    from vulkanhybridrenderer_tpu_torch.runtime import dispatch as pdispatch
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu_torch.scene import procedural

    n_cards = torch.cuda.device_count()
    kind = "real" if n_cards >= 2 else "virtual"

    def make_mesh():
        return pmesh.make_mesh() if n_cards >= 2 else pmesh.make_mesh([dev] * 4)

    cards = make_mesh().distinct()

    def sync_all():
        for d in cards:
            torch.cuda.synchronize(d)

    def animate_pica(r, f):
        r.animate(procedural.animate_pica(pica, f / 60.0))

    ssr_cfg = dataclasses.replace(raster_cfg, hybrid=dataclasses.replace(
        raster_cfg.hybrid, reflection_mode=ReflectionMode.SSR))
    half_cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(cfg.hybrid, rt_scale=2))
    rt_cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                          raytraced=cfgmod.RaytracedSettings(test_alpha=True))
    ss4_cfg = RenderConfig(width=WIDTH, height=HEIGHT, forward=cfgmod.ForwardSettings(
        msaa_samples=4, msaa_mode="supersample"))
    # (label, scene, config, path, animate, timed): "eager" times the eager
    # mesh frame too, "captured" one card and the captured mesh frame; SSR's
    # frame (~0.5 s on one card) is checked, not timed
    cases = (("path 8", realglb, cfg, "hybrid", None, "eager"),
             ("cell 4", realglb, raster_cfg, "hybrid", None, "eager"),
             ("cell 4 with SSR", realglb, ssr_cfg, "hybrid", None, None),
             ("full at rt_scale=2", realglb, half_cfg, "hybrid", None, "eager"),
             ("path 11, animated pica", pica, pica_cfg, "hybrid", animate_pica, "eager"),
             ("raytraced, test_alpha", realglb, rt_cfg, "raytraced", None, "captured"),
             ("rayquery", realglb, RenderConfig(width=WIDTH, height=HEIGHT), "rayquery", None,
              "captured"),
             ("forward", realglb, RenderConfig(width=WIDTH, height=HEIGHT), "forward", None,
              "captured"),
             ("forward, supersample 4", realglb, ss4_cfg, "forward", None, "captured"))
    # one host build a (scene, table knobs), read in place on the primary
    bvhs = {}
    timed_counts = {}
    for label, scene, cfg_, path, animate, timed in cases:
        camera = copy.deepcopy(scene.camera)
        one = Renderer(scene, cfg_, path=path, device=dev)
        key = (id(scene), cfg_.bvh_dtype, cfg_.bvh_leaf_max, cfg_.animated)
        if key in bvhs:
            one._bvh = bvhs[key]
        bvh = bvhs[key] = one._get_bvh()
        rs = {"eager": Renderer(scene, cfg_, path=path, mesh=make_mesh()),
              "fused": Renderer(scene, cfg_, path=path, mesh=make_mesh()),
              "per_pass": Renderer(scene, cfg_, path=path, mesh=make_mesh(),
                                   dispatch="per_pass")}
        for r in rs.values():
            # the set-up's reads back (a host BVH build, check_binning) before
            # the frames: one host build, read in place on the primary
            r._bvh, r._shade_tables = bvh, one._get_shade_tables()
            prev = (r._prev_view, r._prev_proj)
            r.check_binning()
            r._prev_view, r._prev_proj = prev
            r._binning_checked = True
            r._consts()
        n = rs["eager"].mesh.devices.size
        counted = {m: pdispatch.counters(r.mesh) for m, r in rs.items()}
        equal, replayed_same, when, eager_counts = True, True, {}, []
        for f in range(4):
            one.update_camera(1 / 30, keys={"w"} if f % 2 else {"a"})
            for r in (one, *rs.values()):
                if animate is not None:
                    animate(r, f)
            want = one.render_frame()
            per = {}
            for m, r in rs.items():
                before = pdispatch.snapshot(counted[m])
                if m != "eager" and (r._captured is None or not r._captured.captured):
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    img = _eager_mesh_frame(r) if m == "eager" else r.render_frame(sync=False)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                sync_all()
                per[m] = pdispatch.delta(before, pdispatch.snapshot(counted[m]))
                if m != "eager" and r._captured.captured:
                    when.setdefault(m, f)
                eq = torch.equal(img, want)
                equal &= eq
                if not eq:
                    print(f"mesh capture: {label} frame {f} {m} DIFFERS from one card's on "
                          f"{int((img != want).any(dim=0).sum())} pixels (max "
                          f"{_max_abs(img - want):.3g})")
            eager_counts.append(_named_counts(per["eager"]))
            if f >= 2:
                for m in ("fused", "per_pass"):
                    same = per[m] == per["eager"]
                    replayed_same &= same
                    if not same:
                        print(f"mesh capture: {label} frame {f} {m} counted {per[m]}, the eager "
                              f"frame {per['eager']}")
        cfu, cpp = rs["fused"]._captured, rs["per_pass"]._captured
        n_pass = len(rs["eager"].graph.find_execution_order())
        moved = dict(per["fused"][-1])
        print(f"mesh capture: {label} over a {kind} mesh of {n} "
              f"(cards {[str(d) for d in rs['fused'].mesh.distinct()]}): frames 0-3 of fused, "
              f"per_pass and eager mesh frames {'all equal' if equal else 'NOT all equal'} to one "
              f"card's; captured at frame fused {when.get('fused')}, per_pass "
              f"{when.get('per_pass')} (precompile_passes); graphs a frame fused {cfu.n_graphs}, "
              f"per_pass {cpp.n_graphs} ({n_pass} passes); capture s fused "
              f"{sum(cfu.capture_s.values()):.3f}, per_pass {sum(cpp.capture_s.values()):.3f}; "
              f"a replayed frame's counts equal the eager frame's: {replayed_same} (bytes "
              f"between shards by kind " + ", ".join(f"{k} {v}" for k, v in sorted(moved.items()))
              + f") | card: {smi}")
        _check(equal, f"mesh capture: {label}: a frame differs")
        _check(replayed_same, f"mesh capture: {label}: a replayed frame counts another frame")
        _check(cfu.n_graphs == 1 and cpp.n_graphs == n_pass and when == {"fused": 1,
                                                                           "per_pass": 0},
               f"mesh capture: {label}: graphs {cfu.n_graphs} / {cpp.n_graphs}, captured {when}")
        if path == "hybrid":
            _check(moved.get("halo", 0) > 0 or moved.get("gather", 0) > 0,
                   f"mesh capture: {label}: a replayed frame exchanged nothing: {moved}")
        else:
            # each shard reads only its own rows: no halo, no gather
            _check(moved.get("halo", 0) == 0 and moved.get("gather", 0) == 0,
                   f"mesh capture: {label}: a replayed frame moved halos or gathers: {moved}")
            mode = ({"filtered closest-hit": n, "filtered any-hit": n} if path == "raytraced"
                    else {"any-hit": n} if path == "rayquery" else {})
            want_counts = {_k2_name(bvh.kind, k): v for k, v in mode.items()}
            # a K1a a shard and image rastered: the frame's (rayquery,
            # forward) and the forward path's 4096^2 shadow map
            want_counts["K1a"] = {"raytraced": 0, "rayquery": n, "forward": 2 * n}[path]
            for f, c in enumerate(eager_counts):
                got = {k: c.get(k, 0) for k in want_counts}
                k2_other = {k for k in c if k.startswith("K2 ")} - set(want_counts)
                _check(got == want_counts and not k2_other,
                       f"mesh capture: {label}: eager frame {f} launched {c}, want {want_counts}")
            print(f"mesh capture: {label}: every eager frame launched {want_counts} (K1a once "
                  f"a shard and image, K2 once a slab and wavefront; {bvh.kind} rows)")
            res = rs["eager"]._resources(rs["eager"]._make_pfd())
            for _ in range(2):  # the second run timed
                clock = pmesh.ShardClock(rs["eager"].mesh)
                pmesh.run_sharded(rs["eager"].graph, rs["eager"].mesh, res, HEIGHT, WIDTH,
                                  clock=clock)
            for name, shards in clock.ms().items():
                print(f"mesh capture: {label}: {name} device ms per shard "
                      f"{' / '.join(f'{x:.3f}' for x in shards)} (sum {sum(shards):.3f}) | "
                      f"card: {smi}")
            del res

        def ms(r, m, frames):
            """ms/frame of `frames` frames after 2 warm-up ones, and their
            counts (_named_counts)."""
            for f in range(2):
                if animate is not None:
                    animate(r, f)
                _eager_mesh_frame(r) if m == "eager" else r.render_frame()
            sync_all()
            c = counted.get(m, pdispatch.counters(None))
            before = pdispatch.snapshot(c)
            main = torch.cuda.current_stream(dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(main)
            for f in range(frames):
                if animate is not None:
                    animate(r, f)
                _eager_mesh_frame(r) if m == "eager" else r.render_frame(sync=False)
            end.record(main)
            sync_all()
            return start.elapsed_time(end) / frames, pdispatch.delta(before,
                                                                      pdispatch.snapshot(c))

        times = collections.defaultdict(list)
        turns = {"eager": ("one", "eager", "fused", "fused", "eager", "one"),
                 "captured": ("one", "fused", "fused", "one"), None: ()}[timed]
        for m in turns:
            r = one if m == "one" else rs[m]
            t, d = ms(r, m, 5 if m == "eager" else 10)
            times[m].append(t)
            if m == "fused" and timed == "captured" and label not in timed_counts:
                timed_counts[label] = _named_counts(d)
        if timed == "eager":
            print(f"mesh capture: {label} ms/frame in turns (one card fused, mesh eager, mesh "
                  f"captured, mesh captured, mesh eager, one card fused): one card "
                  f"{times['one'][0]:.3f} / {times['one'][1]:.3f}, {kind} mesh eager "
                  f"{times['eager'][0]:.3f} / {times['eager'][1]:.3f}, captured "
                  f"{times['fused'][0]:.3f} / {times['fused'][1]:.3f} | card: {smi}")
        elif timed == "captured":
            print(f"mesh capture: {label} ms/frame in turns (one card fused, mesh captured, "
                  f"mesh captured, one card fused): one card {times['one'][0]:.3f} / "
                  f"{times['one'][1]:.3f}, {kind} mesh of {n} captured {times['fused'][0]:.3f} / "
                  f"{times['fused'][1]:.3f} | launches in the first captured turn's 10 frames "
                  f"{timed_counts[label]} | card: {smi}")
        scene.camera = camera
        del one, rs
        torch.cuda.empty_cache()
    return timed_counts, bvhs[(id(realglb), "auto", 0, False)]


def _mesh_path_kernels(realglb, bvh, dev, k1_equal, k1_bound, k2_wave, timed_counts):
    """The other paths' kernel instances over the mesh (make_mesh() where
    the machine has two cards or more, else a virtual mesh of 4) against
    their plain versions, timed, with their bounds: K2 filtered
    closest-hit on the raytraced frame's slab-0 primary rays and filtered
    any-hit on their shadow rays (test_alpha, second frame), K2 any-hit on
    the rayquery frame's slab-0 shadow rays (resolved from band 0 of the
    sort-last raster), K1a on shard 0's triangles of the forward frame's
    3840x2160 supersample raster.  Returns the JSON line's entries and
    their launches, the first captured turn's 10 frames of each path
    (timed_counts; the supersample frame's K1a count holds its 4096^2
    shadow map's shards too)."""
    from vulkanhybridrenderer_tpu_torch.core import config as cfgmod
    from vulkanhybridrenderer_tpu_torch.core.config import RenderConfig
    from vulkanhybridrenderer_tpu_torch.models import rayquery as rayquery_path
    from vulkanhybridrenderer_tpu_torch.models import raytraced as raytraced_path
    from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt
    from vulkanhybridrenderer_tpu_torch.ops import rt_shade, shade, traverse
    from vulkanhybridrenderer_tpu_torch.ops.rasterizer import triangle_setup
    from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer

    mesh = pmesh.make_mesh() if torch.cuda.device_count() >= 2 else pmesh.make_mesh([dev] * 4)
    n = mesh.devices.size
    rows = mesh.rows(0, HEIGHT)
    entries, launches = {}, {}

    def second_frame(cfg, path, *names):
        r = Renderer(realglb, cfg, path=path, device=dev)
        r._bvh = bvh
        r.render_frame()
        return r.fetch_resources(*names)

    # the raytraced frame with test_alpha: slab 0's rays, through the filter
    res = second_frame(RenderConfig(width=WIDTH, height=HEIGHT, raytraced=cfgmod.RaytracedSettings(
        test_alpha=True)), "raytraced", "pfd", "BVH", "shade_tables", "TriRows")
    pfd, b, tables = res["pfd"], res["BVH"], res["shade_tables"]
    o, d = raytraced_path.primary_rays(pfd, HEIGHT, WIDTH, rows)
    p_tmax = torch.full((o.shape[0],), raytraced_path.TMAX, device=dev)
    k = traverse.trace(b, None, o, d, raytraced_path.PRIMARY_TMIN, p_tmax, alpha_tables=tables)
    u = traverse.trace(b, None, o, d, raytraced_path.PRIMARY_TMIN, p_tmax)
    pos = rt_shade.interpolate_hit_attributes(tables, res["TriRows"], k.tri, k.u,
                                              k.v)["position"].contiguous()
    s_dir = (-pfd.directional_light.direction[:3]).expand(pos.shape).contiguous()
    s_tmax = torch.where(k.hit, raytraced_path.TMAX, -1.0)
    ks = traverse.trace(b, None, pos, s_dir, raytraced_path.SHADOW_TMIN, s_tmax, anyhit=True,
                        alpha_tables=tables)
    us = traverse.trace(b, None, pos, s_dir, raytraced_path.SHADOW_TMIN, s_tmax, anyhit=True)
    for mode, (oo, dd, tmin, tmax, anyhit, kk, uu) in {
            "filtered closest-hit": (o, d, raytraced_path.PRIMARY_TMIN, p_tmax, False, k, u),
            "filtered any-hit": (pos, s_dir, raytraced_path.SHADOW_TMIN, s_tmax, True, ks, us),
    }.items():
        # the bound's bytes add the tri_static rows (240 bytes) of the
        # triangles hit with or without the filter, as the frame's row
        tris = torch.unique(torch.cat([kk.tri, uu.tri]))
        name = _k2_name(b.kind, mode)
        entries[f"{name} raytraced mesh slab"] = k2_wave(
            b, f"raytraced mesh slab 0 of {n} {'shadow' if anyhit else 'primary'}", oo, dd,
            tmin, tmax, anyhit, tables, plain_timed=True, extra_bytes=int((tris >= 0).sum()) * 240)
        launches[f"{name} raytraced mesh slab"] = timed_counts["raytraced, test_alpha"][name]
    del res, o, d, k, u, pos, s_dir, ks, us

    # the rayquery frame: band 0 of the sort-last raster resolved, its
    # shadow rays any-hit
    res = second_frame(RenderConfig(width=WIDTH, height=HEIGHT), "rayquery", "scene", "pfd",
                       "Clip", "BVH", "shade_tables", "TriRows")
    band = pmesh.rasterize_scene_bands(res["scene"], res["Clip"], WIDTH, HEIGHT, mesh,
                                       alpha=False, tables=res["shade_tables"])[0]
    attrs = shade.resolve_forward_attributes(res["scene"], res["shade_tables"], res["TriRows"],
                                             band)
    origins = attrs["position"].reshape(-1, 3).contiguous()
    dirs = (-res["pfd"].directional_light.direction[:3]).expand(origins.shape).contiguous()
    tmax = torch.where(attrs["valid"].reshape(-1), rayquery_path.SHADOW_TMAX, -1.0)
    _check(origins.shape[0] == rows.count * WIDTH, f"rayquery band 0 has {origins.shape[0]} rays")
    name = _k2_name(res["BVH"].kind, "any-hit")
    entries[f"{name} rayquery mesh slab"] = k2_wave(
        res["BVH"], f"rayquery mesh slab 0 of {n} shadow", origins, dirs,
        rayquery_path.SHADOW_TMIN, tmax, True, plain_timed=True)
    launches[f"{name} rayquery mesh slab"] = timed_counts["rayquery"][name]
    del res, band, attrs, origins, dirs, tmax

    # the forward frame at supersample 4: K1a on shard 0's triangles of
    # the 3840x2160 raster (the opaque stream; the masked ones are peeled)
    w2, h2 = 2 * WIDTH, 2 * HEIGHT
    res = second_frame(RenderConfig(width=WIDTH, height=HEIGHT, forward=cfgmod.ForwardSettings(
        msaa_samples=4, msaa_mode="supersample")), "forward", "scene", "Clip")
    sc = res["scene"]
    setup = triangle_setup(res["Clip"], sc.tri_vertex, w2, h2)
    per = -(-setup.planes.shape[0] // n)
    sub = type(setup)(**{f: getattr(setup, f)[:per]
                         for f in ("planes", "sx", "sy", "bbox", "w_any", "front", "valid")})
    opaque, _ = rt.opaque_include(sc, True)
    bins = rt.bin_triangles(sub, w2, h2, include=None if opaque is None else opaque[:per])
    _check(int(bins.overflow[0]) == 0, f"the {w2}x{h2} shard's binning overflowed its entry cap "
           f"by {int(bins.overflow[0])}")
    err = k1_equal(f"mesh: K1a on shard 0's {per} triangles of the {w2}x{h2} supersample raster",
                   rt.raster_tiles(sub.planes, bins, w2, h2),
                   rt.raster_tiles_plain(sub.planes, bins, w2, h2))
    kb = k1_bound("K1a", sub.planes, bins, w2 * h2)
    k_ms = _cuda_ms(lambda: rt.raster_tiles(sub.planes, bins, w2, h2), 20)
    p_ms = _cuda_ms(lambda: rt.raster_tiles_plain(sub.planes, bins, w2, h2), 2)
    entries["K1a supersample mesh shard"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                                 bound_ms=kb["bound_ms"], bound_by=kb["bound_by"])
    launches["K1a supersample mesh shard"] = timed_counts["forward, supersample 4"]["K1a"]
    print(f"mesh: K1a on supersample shard 0: {kb['entries']} entries, {kb['pairs']} passing "
          f"(entry, sub-tile) pairs, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{kb['bound_ms']:.4f} ms (set by {kb['bound_by']}; dense {kb['dense_bound_ms']:.4f})")
    del res, setup, sub, bins
    torch.cuda.empty_cache()
    return entries, launches


def _mesh_frame(label, single, meshed, mesh, sync_all, smi):
    """Phase 6c (d) on one configuration: a whole mesh frame queued under
    torch.cuda.set_sync_debug_mode("error") (a synchronizing call raises);
    the bytes a frame moves between shards, by kind; each pass's device ms
    on each shard (parallel/mesh.ShardClock: CUDA events on each shard's
    stream around its share of the pass) beside one card's time_passes."""
    from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh

    meshed.render_frame()
    sync_all()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame = meshed.render_frame(sync=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_all()
    _check(bool(torch.isfinite(frame).all()), f"{label}'s mesh frame not finite")
    print(f"mesh: {label}: a whole mesh frame under set_sync_debug_mode('error'): no "
          "synchronizing call")
    mesh.moved.clear()
    meshed.render_frame()
    sync_all()
    moved = dict(mesh.moved)
    print(f"mesh: {label}: bytes a frame moves between shards (as {mesh.devices.size} distinct "
          f"cards would): " + ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in sorted(moved.items()))
          + f"; halos {moved.get('halo', 0) / 1e6:.3f} MB, gathers "
          f"{moved.get('gather', 0) / 1e6:.3f} MB")
    _check(moved.get("halo", 0) > 0 and moved.get("gather", 0) > 0,
           f"{label}'s mesh frame exchanged no halo or no gather: {moved}")
    res = meshed._resources(meshed._make_pfd())
    for _ in range(2):  # the second run timed
        clock = pmesh.ShardClock(mesh)
        pmesh.run_sharded(meshed.graph, mesh, res, HEIGHT, WIDTH, clock=clock)
    per_shard = clock.ms()
    one = single.time_passes(iters=3)
    for name, shards in per_shard.items():
        print(f"mesh: {label}: {name} device ms per shard "
              f"{' / '.join(f'{x:.3f}' for x in shards)} (sum {sum(shards):.3f}); one card "
              f"{one.get(name, float('nan')):.3f} (time_passes, 3 iterations) | card: {smi}")
    want = {"G-Buffer Pass", "Composition Pass"}
    _check(want <= set(per_shard), f"{label}: no per-shard time of {want - set(per_shard)}")


def _parent_walk(other, build, dev):
    """walk(kind, tab, idx0, steps) -> (ids, sums) through another
    checkout's probe_walk_launch, bound by the names of its prototype's
    parameters."""
    from vulkanhybridrenderer_tpu_torch.probes.gather import KINDS

    fn, params = other
    own = _c_params(build.CSRC_DIR / "gather_probe.cu", "probe_walk_launch")

    def walk(kind, tab, idx0, steps):
        # the current stream at each call: a CUDA graph captures on its own
        stream = build.current_stream(dev.index)
        w = idx0.shape[0]
        out_idx = torch.empty(w, dtype=torch.int32, device=dev)
        out_acc = torch.empty((w, 128) if kind == KINDS["rows-acc"] else w,
                              dtype=torch.float32, device=dev)
        values = dict(kind=kind, tab=tab.data_ptr(), idx0=idx0.data_ptr(),
                      w=w, steps=steps, n=tab.shape[0], out_idx=out_idx.data_ptr(),
                      out_acc=out_acc.data_ptr(), device=dev.index, stream=stream)
        err = fn(*_bind(params, own, [values[name] for name, _ in own]))
        _check(err == 0, f"the other checkout's probe walk {kind}: CUDA error {err}")
        return out_idx, out_acc

    return walk


def _animated_wavefronts(pica, cfg, dev, bound, other_k3=None):
    """Path 11's frame 5 (animate_pica(pica, i / 60) before frame i): the
    in-frame grid's bytes; K3's shadow mask against its plain version
    (timed, and with other_k3 in turns with it), K2 any-hit on the refit BVH8 and
    K2 any-hit on a fresh host BVH8 of the moved triangles; AO any-hit and
    reflection closest-hit through the refit tree against the fresh one
    (closest hits: t within 1e-4, the triangle equal but where two hits tie
    in t); the refit rows against refit8 run again on the card and on the
    CPU."""
    from vulkanhybridrenderer_tpu_torch.models import hybrid as hybrid_path
    from vulkanhybridrenderer_tpu_torch.ops import bvh8 as bvh8_ops, raygen, shadowgrid, traverse
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu_torch.scene import procedural

    r = Renderer(pica, cfg, device=dev)
    for i in range(5):
        r.animate(procedural.animate_pica(pica, i / 60.0))
        r.render_frame()
    r.animate(procedural.animate_pica(pica, 5 / 60.0))
    res = r.fetch_resources("pfd", "BVH", "ShadowGrid", "WorldTris", hybrid_path.DEPTH,
                            hybrid_path.NORMALS)
    refit, tris = res["BVH"], res["WorldTris"]
    fresh = bvh8_ops.build_bvh8_sah_host(tris.cpu().numpy()).to(dev)
    rays = raygen.Wavefronts(res["pfd"], res[hybrid_path.DEPTH], res[hybrid_path.NORMALS],
                             cfg.hybrid, ao_rays=cfg.ao_rays)
    print(f"K3 grid of path 11's frame 5 (rebuilt in the frame): {_grid_bytes(res['ShadowGrid'])}")
    _k3_wave(refit, res["ShadowGrid"], rays.origin, rays.shadow_dir, raygen.SHADOW_TMIN,
             rays.shadow_tmax, bound, "path 11's frame 5 shadow (refit BVH8)", width=cfg.width,
             timed=True, other_k3=other_k3, long_lists=False)
    k3 = shadowgrid.trace_shadow(res["ShadowGrid"], rays.origin, rays.shadow_dir,
                                 raygen.SHADOW_TMIN, rays.shadow_tmax, width=cfg.width)
    fresh_hit = traverse.trace(fresh, None, rays.origin, rays.shadow_dir, raygen.SHADOW_TMIN,
                               rays.shadow_tmax, anyhit=True).hit
    fresh_diff = int((k3 != fresh_hit).sum())
    o_ao = rays.origin.repeat(cfg.ao_rays, 1)
    t_ao = rays.ao_tmax.repeat(cfg.ao_rays)
    ao_diff = int((traverse.trace(refit, None, o_ao, rays.ao_dir, raygen.SHADOW_TMIN, t_ao,
                                  anyhit=True).hit
                   != traverse.trace(fresh, None, o_ao, rays.ao_dir, raygen.SHADOW_TMIN, t_ao,
                                     anyhit=True).hit).sum())
    a = traverse.trace(refit, None, rays.origin, rays.refl_dir, raygen.SHADOW_TMIN, rays.refl_tmax)
    f = traverse.trace(fresh, None, rays.origin, rays.refl_dir, raygen.SHADOW_TMIN, rays.refl_tmax)
    t_err = _max_abs(a.t - f.t)
    tri_diff = a.tri != f.tri
    ties = tri_diff & a.hit & f.hit & (a.t == f.t)
    on_card = torch.equal(refit.rows, bvh8_ops.refit8(r._get_bvh(), tris).rows)
    on_cpu = torch.equal(refit.rows.cpu(), bvh8_ops.refit8(r._get_bvh().to("cpu"), tris.cpu()).rows)
    print(f"path 11 frame 5: K3 against K2 any-hit on a fresh host BVH8 of the moved triangles: "
          f"{fresh_diff} mismatched hit flags; AO any-hit refit against fresh: {ao_diff}; "
          f"reflection closest-hit refit against fresh: {int(a.hit.sum())} hits, tri differs on "
          f"{int(tri_diff.sum())} rays ({int(ties.sum())} of them equal-t ties), max |t diff| "
          f"{t_err:.3g} (limit 1e-4); refit rows equal refit8 on the card {on_card}, on the "
          f"CPU {on_cpu}; BVH8 {refit.num_rows} rows, depth bound {refit.depth}")
    _check(fresh_diff == 0 and ao_diff == 0, "the refit BVH8's any-hit masks differ from a "
           f"fresh build's: shadow {fresh_diff}, AO {ao_diff}")
    _check(t_err <= 1e-4 and bool((tri_diff == ties).all()),
           f"closest hits through the refit BVH8 differ from a fresh build's: t {t_err}, "
           f"tri {int(tri_diff.sum())} ({int(ties.sum())} ties)")
    _check(on_card and on_cpu, "the BVH Refit pass's rows differ from refit8's")


def _route_renderer(scene, cfg, dev):
    """Main path 12's renderer: built, and its BVH8 made, by the renderer's
    own route without a native build (inside _no_native); that BVH8 held
    equal to the native collapse of the same device LBVH and to an explicit
    Python collapse (each re-encoded by table_to_bf16 where the route's
    table rule picked bf16 rows), with the host seconds of each;
    validate_host on the Python and the native collapse.  Returns
    (renderer, its BVH8, the LBVH, its triangles, the native BVH8 on dev)."""
    from vulkanhybridrenderer_tpu_torch import native_bridge
    from vulkanhybridrenderer_tpu_torch.ops import bvh8 as bvh8_ops
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer

    with _no_native(native_bridge):
        r = Renderer(scene, cfg, device=dev)
        t = time.perf_counter()
        route8 = r._get_bvh()
        route_s = time.perf_counter() - t
    lbvh, world_tris, lbvh8, native_s = _lbvh8(r)
    tris_np = world_tris.cpu().numpy()
    t = time.perf_counter()
    python8 = bvh8_ops.build_bvh8_host(lbvh, tris_np, prefer_native=False)
    python_s = time.perf_counter() - t
    kind = route8.kind
    want = bvh8_ops.table_to_bf16(lbvh8) if kind == "bf16-8" else lbvh8
    same = {f: torch.equal(getattr(route8, f).cpu(), getattr(want, f).cpu())
            for f in ("rows", "child8", "valid8", "tri8")}
    same["depth"] = route8.depth == lbvh8.depth == python8.depth
    same["python collapse"] = torch.equal(python8.rows, lbvh8.rows.cpu())
    print(f"path 12: {scene.name}'s BVH8 by the renderer's no-native route (device LBVH + "
          f"Python collapse + upload) {route_s:.3f} s, {kind} rows, {route8.num_rows} rows, "
          f"depth bound {route8.depth}; equal to the native collapse of the same device LBVH"
          f"{' re-encoded in bf16' if kind == 'bf16-8' else ''}: {same}; host seconds on the "
          f"LBVH's {tris_np.shape[0]} triangles: native collapse {native_s:.3f} s, Python "
          f"collapse {python_s:.3f} s")
    _check(all(same.values()), f"the no-native route's BVH8 differs from the native collapse: "
           f"{same}")
    print("path 12: " + _validate(bvh8_ops, python8, world_tris, "the LBVH's Python collapse")
          + "; " + _validate(bvh8_ops, lbvh8, world_tris, "the LBVH's native collapse"))
    return r, route8, lbvh, world_tris, lbvh8


def _lbvh8(r):
    """The native collapse of the device LBVH of renderer `r`'s world
    triangles (ops/bvh.build on r's device): the yardstick main path 12's
    no-native route is held to.  Returns (LBVH, triangles, BVH8 on r's
    device, the collapse's host seconds)."""
    from vulkanhybridrenderer_tpu_torch.ops import bvh as bvh_ops, bvh8 as bvh8_ops, geometry

    world = geometry.to_world(r.buffers, r.prim_transform)
    tris = bvh_ops.world_triangles(world.position, r.buffers.tri_vertex)
    lbvh = bvh_ops.build(tris)
    tris_np = tris.cpu().numpy()
    t = time.perf_counter()
    native = bvh8_ops.build_bvh8_host(lbvh, tris_np, prefer_native=True)
    seconds = time.perf_counter() - t
    return lbvh, tris, native.to(r.device), seconds


@contextlib.contextmanager
def _no_native(native_bridge):
    """The port's native_available() returns False, and its native library
    cannot be loaded, inside the block: renderers that build their BVH8
    there take the no-native route.  Both are restored afterwards."""
    saved = native_bridge.native_available, native_bridge.load

    def refuse():
        raise RuntimeError("the native library was asked for on the no-native route")

    native_bridge.native_available, native_bridge.load = (lambda: False), refuse
    try:
        yield
    finally:
        native_bridge.native_available, native_bridge.load = saved


def _validate(bvh8_ops, b, tris, label: str) -> str:
    """bvh8.validate_host on `b` over its triangles (raises on a
    violation); a line with its host seconds."""
    t = time.perf_counter()
    bvh8_ops.validate_host(b, tris)
    return f"validate_host passed on {label} ({b.num_rows} rows) in {time.perf_counter() - t:.3f} s"


def _lbvh_oracle(tris, sah, wavefronts, bound, tables, other_k4=None):
    """The device LBVH and K4 on one frame (`tris` its world triangles on
    the card, `sah` its SAH BVH8, `wavefronts` name -> (origin, dir, tmax,
    any-hit), `tables` its shade tables): the build's time by CUDA events,
    its true depth, the native host LBVH's time and equality, validate_host;
    pack_flat's time (once per tree).  Per wavefront, K4 over the LBVH's
    tables against trace_flat_plain (t, tri, u, v equal on every ray),
    unfiltered and filtered; the wrapper's time, the kernel alone's (the C
    launch on prepared arguments), the plain version's and K2's on the same
    rays; the bound (K2_OPS_BOX a visited internal node, K2_OPS_TRI a tested
    triangle; or the tables' and rays' bytes); nodes and triangles a live
    ray; the lane share of 32 rays in pixel order (the parent's thread-a-ray
    schedule) and the kernel's own count (its stats); `other_k4` (another
    checkout's K4, _other_launch: given this one's tables when it has this
    one's prototype, else pack_nodes' rows, pack_tris' and the order)
    checked equal and timed in turns.  K4 against
    K2 on the SAH BVH8 (the oracle: hit flags, and for closest hits t within
    1e-4 and the same triangle unless the two t are equal) on >= 99.99% of
    live rays.  K4 over the SAH binary tree (native_bridge.build_sah_host,
    leaves of one) against its plain version and K2, timed in turns with K2
    on the SAH BVH8 collapsed from it.  The refit for a rigid move against a
    fresh build of the moved triangles (K4's hit masks equal).  Returns (the
    LBVH, the JSON line's K4 entries: AO any-hit and reflection
    closest-hit)."""
    from vulkanhybridrenderer_tpu_torch import native_bridge
    from vulkanhybridrenderer_tpu_torch.ops import bvh as bvh_ops, raygen, traverse
    from vulkanhybridrenderer_tpu_torch.probes.gather import turns
    from vulkanhybridrenderer_tpu_torch.utils import build

    dev = tris.device
    build_ms = _cuda_ms(lambda: bvh_ops.build(tris), 3)
    lbvh = bvh_ops.build(tris)
    depth = bvh_ops.tree_depth(lbvh)
    t = time.perf_counter()
    native = native_bridge.build_bvh_host(tris.cpu().numpy())
    native_s = time.perf_counter() - t
    same = {f: torch.equal(getattr(lbvh, f).cpu(), getattr(native, f))
            for f in ("order", "left", "right", "escape")}
    box = max(_max_abs(lbvh.aabb_min.cpu() - native.aabb_min),
              _max_abs(lbvh.aabb_max.cpu() - native.aabb_max))
    t = time.perf_counter()
    bvh_ops.validate_host(lbvh)
    validate_s = time.perf_counter() - t
    print(f"device LBVH of {tris.shape[0]} triangles: build {build_ms:.3f} ms on the card (CUDA "
          f"events, mean of 3), {lbvh.left.shape[0]} nodes, true depth {depth} (the build's "
          f"sweeps: 64); native host LBVH (native/lbvh.cpp) {native_s * 1e3:.3f} ms; order / "
          f"left / right / escape equal {same}, boxes within {box:.3g} (limit 1e-6); "
          f"validate_host passed in {validate_s:.3f} s")
    _check(all(same.values()) and box <= 1e-6,
           f"the device LBVH differs from the native one: {same}, boxes {box}")
    _check(depth <= 64, f"realglb's LBVH is {depth} deep: the build's 64 sweeps leave it stale")

    torch.cuda.synchronize()
    t = time.perf_counter()
    flat = traverse.pack_flat(lbvh, tris)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t
    sah_bin = native_bridge.build_sah_host(tris.cpu().numpy()).to(dev)
    flat_sah = traverse.pack_flat(sah_bin, tris)
    # the parent's inputs: pack_nodes' rows in build order, pack_tris', the order
    nodes_p, tris9 = traverse.pack_nodes(lbvh), traverse.pack_tris(tris)
    steps = traverse.default_flat_max_steps(flat)
    _check(steps == traverse.default_flat_max_steps(flat_sah), "the trees' step caps differ")
    print(f"pack_flat (once per tree): {pack_s * 1e3:.3f} ms host wall time (internal node "
          f"rows {flat.nodes.numel() * 4} bytes, leaf slots "
          f"{flat.leaf_tris.numel() * 4} bytes); the SAH binary tree (native/sah.cpp): "
          f"{sah_bin.left.shape[0]} nodes, leaves of {sah_bin.leaf_size}")
    fn = traverse.load_flat_kernel()
    own_params = _c_params(build.CSRC_DIR / "bvh_flat_trace.cu", "bvh_flat_trace_launch")
    filt = traverse.make_alpha_hit_filter(None, tables)
    entries = {}

    def stat(x):
        return (f"mean {float(x.mean()) if x.numel() else 0.0:.2f}, p99 "
                f"{float(torch.quantile(x, 0.99)) if x.numel() else 0.0:.0f}")

    def empty_hits(n):
        return traverse.HitRecord(
            t=torch.empty(n, device=dev), tri=torch.empty(n, dtype=torch.int32, device=dev),
            u=torch.empty(n, device=dev), v=torch.empty(n, device=dev))

    def differ(a, b):
        return {f: int((getattr(a, f) != getattr(b, f)).sum()) for f in ("t", "tri", "u", "v")}

    def oracle(k, k2, live, anyhit):
        if anyhit:
            agree = k.hit == k2.hit
        else:
            agree = ((k.hit == k2.hit) & ((k.t - k2.t).abs() <= 1e-4)
                     & ((k.tri == k2.tri) | (k.t == k2.t)))
        bad = torch.nonzero(live & ~agree).squeeze(1)
        return 1.0 - bad.numel() / max(int(live.sum()), 1), bad

    def turns_line(label, t):
        other, mine = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        return (f"{label} in turns (other, this, this, other): {t[0]:.4f} / {t[3]:.4f} ms "
                f"against {t[1]:.4f} / {t[2]:.4f} ms: this one {other / mine:.4f}x as fast")

    for name, (o, d, tmax, anyhit) in wavefronts.items():
        n = o.shape[0]
        mode = "any-hit" if anyhit else "closest-hit"
        tmin = torch.full((n,), raygen.SHADOW_TMIN, device=dev)
        live = tmax >= tmin
        k = traverse.trace_flat(flat, o, d, tmin, tmax, anyhit=anyhit)
        p, vis = traverse.trace_flat_plain(flat, o, d, tmin, tmax, anyhit, steps, visits=True)
        diff = differ(k, p)
        err = max(_max_abs(k.t - p.t), _max_abs(k.u - p.u), _max_abs(k.v - p.v),
                  float(diff["tri"]))
        _check(not any(diff.values()),
               f"K4 {mode} differs from its plain version on the {name} rays: {diff}")
        kf = traverse.trace_flat(flat, o, d, tmin, tmax, anyhit=anyhit, alpha_tables=tables)
        pf = traverse.trace_flat_plain(flat, o, d, tmin, tmax, anyhit, steps, filt)
        fdiff = differ(kf, pf)
        _check(not any(fdiff.values()),
               f"the filtered K4 {mode} differs from its plain version on the {name} rays: {fdiff}")
        out = empty_hits(n)
        args = traverse.flat_launch_args(flat, o, d, tmin, tmax, anyhit, steps, None, out)
        ms = _cuda_ms(lambda: traverse.trace_flat(flat, o, d, tmin, tmax, anyhit=anyhit), 20)
        alone_ms = _cuda_ms(lambda: fn(*args), 20)
        filtered_ms = _cuda_ms(lambda: traverse.trace_flat(flat, o, d, tmin, tmax, anyhit=anyhit,
                                                           alpha_tables=tables), 20)
        plain_ms = _cuda_ms(lambda: traverse.trace_flat_plain(flat, o, d, tmin, tmax, anyhit,
                                                              steps), 1)
        k2_ms = _cuda_ms(lambda: traverse.trace(sah, None, o, d, tmin, tmax, anyhit=anyhit), 20)
        internal, tested = int(vis.internal.sum()), int(vis.triangles.sum())
        ops = internal * K2_OPS_BOX + tested * K2_OPS_TRI
        # bytes: the node rows and leaf slots once, the rays in (origin,
        # direction, tmin, tmax), the hits out
        nbytes = (flat.nodes.numel() + flat.leaf_tris.numel()) * 4 + n * (32 + 16)
        b_ms, b_by = bound(ops, nbytes)
        walk = (vis.internal + vis.leaf)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        _check(fn(*traverse.flat_launch_args(flat, o, d, tmin, tmax, anyhit, steps, None,
                                             empty_hits(n), stats)) == 0,
               "the K4 launch with its lane counters failed")
        busy, total = stats.tolist()
        print(f"K4 {mode} bvh_flat_trace, realglb {name} rays: {n} ({int(live.sum())} live), "
              f"hits {int(k.hit.sum())} ({int(kf.hit.sum())} filtered), rays whose t / tri / u / v "
              f"differ from its plain version {' / '.join(map(str, diff.values()))}, filtered "
              f"{' / '.join(map(str, fdiff.values()))}, filtered against unfiltered "
              f"{int((kf.tri != k.tri).sum())}; nodes a live ray "
              f"{stat(walk[live].double())}, triangles {stat(vis.triangles[live].double())}; "
              f"wrapper {ms:.4f} ms, kernel alone {alone_ms:.4f} ms, filtered {filtered_ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, K2 on the SAH BVH8 {k2_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms (set by {b_by}; operations {bound(ops, 0)[0]:.4f} ms, bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), share of the bound {b_ms / ms:.4f} "
              f"(kernel alone {b_ms / alone_ms:.4f})")
        print(f"K4 realglb {name} rays: lane share of 32 rays in pixel order (the parent's "
              f"schedule) {_pixel_lane_share(walk, live):.4f}; the kernel's own count "
              f"{busy / max(total, 1):.4f} ({busy} of {total} lane-steps busy)")

        if other_k4 is not None:
            pfn, pparams = other_k4
            pout = empty_hits(n)
            # a K4 with this one's prototype walks pack_flat's tables; the
            # earlier one (tris9 and order among its parameters) pack_nodes'
            # rows in build order, pack_tris' and the order
            same = [name for name, _ in pparams] == [name for name, _ in own_params]
            pargs = _bind(pparams, own_params, traverse.flat_launch_args(
                flat if same else traverse.FlatTables(nodes_p, flat.leaf_tris, lbvh.leaf_size,
                                                      lbvh.root),
                o, d, tmin, tmax, anyhit, steps, None, pout),
                {"tris9": tris9.data_ptr(), "order": lbvh.order.data_ptr()})
            _check(pfn(*pargs) == 0 and not any(differ(pout, k).values()),
                   f"the other checkout's K4 differs on the {name} rays")
            print(turns_line(f"K4 realglb {name} rays, the other checkout's kernel alone "
                             f"against this one's", turns(lambda: pfn(*pargs),
                                                           lambda: fn(*args), 20)))

        # the oracle: K2 over the SAH BVH8 on the same rays
        k2 = traverse.trace(sah, None, o, d, tmin, tmax, anyhit=anyhit)
        share, bad = oracle(k, k2, live, anyhit)
        print(f"oracle, K4 on the LBVH against K2 on the SAH BVH8, realglb {name} rays: agree on "
              f"{share:.6f} of live rays (limit 0.9999), {bad.numel()} disagree"
              + "".join(f"; ray {int(i)}: K4 t {float(k.t[i]):.6g} tri {int(k.tri[i])}, K2 t "
                        f"{float(k2.t[i]):.6g} tri {int(k2.tri[i])}" for i in bad[:8]))
        _check(share >= 0.9999, f"K4 and K2 agree on {share} of the live {name} rays")

        # K4 over the SAH binary tree, in turns with K2 over its BVH8
        ks = traverse.trace_flat(flat_sah, o, d, tmin, tmax, anyhit=anyhit)
        ps, vis_s = traverse.trace_flat_plain(flat_sah, o, d, tmin, tmax, anyhit, steps,
                                              visits=True)
        sdiff = differ(ks, ps)
        _check(not any(sdiff.values()),
               f"K4 {mode} over the SAH binary tree differs from its plain version on the "
               f"{name} rays: {sdiff}")
        s_share, s_bad = oracle(ks, k2, live, anyhit)
        _check(s_share >= 0.9999, f"K4 on the SAH binary tree and K2 agree on {s_share} of "
               f"the live {name} rays")
        sargs = traverse.flat_launch_args(flat_sah, o, d, tmin, tmax, anyhit, steps, None,
                                          empty_hits(n))
        s_ops = int(vis_s.internal.sum()) * K2_OPS_BOX + int(vis_s.triangles.sum()) * K2_OPS_TRI
        s_bound = bound(s_ops, (flat_sah.nodes.numel() + flat_sah.leaf_tris.numel()) * 4
                        + n * (32 + 16))[0]
        t = turns(lambda: traverse.trace(sah, None, o, d, tmin, tmax, anyhit=anyhit),
                   lambda: traverse.trace_flat(flat_sah, o, d, tmin, tmax, anyhit=anyhit), 20)
        s_alone = _cuda_ms(lambda: fn(*sargs), 20)
        print(f"K4 {mode} over the SAH binary tree, realglb {name} rays: equal to its plain "
              f"version, agrees with K2 on {s_share:.6f} of live rays ({s_bad.numel()} "
              f"disagree); nodes a live ray {stat((vis_s.internal + vis_s.leaf)[live].double())}, "
              f"triangles {stat(vis_s.triangles[live].double())}; kernel alone {s_alone:.4f} ms, "
              f"bound {s_bound:.4f} ms (share {s_bound / s_alone:.4f}); "
              + turns_line("K2 on the SAH BVH8 (wrapper) against K4 on the SAH binary tree "
                           "(wrapper)", t))
        if name != "shadow":
            entries[f"K4 {mode}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                         bound_by=b_by)

    # the refit for a rigid move, against a fresh build of the moved triangles
    offset = torch.tensor([3.0, -2.0, 5.0], device=dev)
    moved = tris + offset
    refit = bvh_ops.refit(lbvh, moved)
    refit_ms = _cuda_ms(lambda: bvh_ops.refit(lbvh, moved), 3)
    fresh = bvh_ops.build(moved)
    topo = all(torch.equal(getattr(refit, f), getattr(fresh, f)) for f in ("order", "left"))
    mism = {}
    for name, (o, d, tmax, anyhit) in wavefronts.items():
        om = o + offset
        mism[name] = int((traverse.trace(refit, moved, om, d, raygen.SHADOW_TMIN, tmax,
                                         anyhit=anyhit).hit
                          != traverse.trace(fresh, moved, om, d, raygen.SHADOW_TMIN, tmax,
                                            anyhit=anyhit).hit).sum())
    print(f"LBVH refit for the triangles moved by {offset.tolist()}: {refit_ms:.3f} ms on the "
          f"card; the fresh build's topology is the same: {topo}; K4 hit masks refit against "
          f"fresh, mismatched rays {mism}")
    _check(not any(mism.values()), f"K4 through the refit LBVH differs from a fresh build: {mism}")
    return lbvh, entries


def _pixel_lane_share(tested, live) -> float:
    """The share of lane-steps that test a row when each group of 32
    consecutive rays (pixel order: the warps of a thread-a-ray walk) walks
    until its longest walk ends: the live rays' (R,) `tested` counts over 32
    lanes times each group's longest walk."""
    t = torch.where(live, tested, 0)
    groups = torch.cat([t, t.new_zeros((-t.numel()) % 32)]).view(-1, 32)
    return float(t.sum()) / max(float(groups.amax(1).sum()) * 32, 1.0)


def _grid_bytes(sg) -> str:
    """A shadow grid's static tables: rows, live rows, bytes."""
    tables = (sg.entries, sg.offsets, sg.big, sg.num_big, sg.frame)
    nbytes = sum(t.numel() * t.element_size() for t in tables)
    return (f"{sg.grid}x{sg.grid} cells, {sg.num_entries} entry rows ({int(sg.offsets[-1])} "
            f"live), {nbytes} bytes ({sg.entries.numel() * 4} of entry rows), num_big "
            f"{int(sg.num_big)}, overflow {int(sg.overflow)}")


def _k3_wave(bvh, sg, o, d, tmin, tmax, bound, label, tables=None, width=None, timed=False,
             other_k3=None, long_lists=True):
    """K3 on one shadow wavefront (`tmin` a float, `tmax` (R,); `width` the
    image's, as the render path passes it) against its plain version and K2
    any-hit on the same rays, unfiltered and, with the scene's shade
    `tables`, filtered: identical hit masks on every ray, else the run
    fails; also without the width, with an (R,) tmin and with a staging
    capacity below the longest cell list (the global-memory path).  Prints
    the rays, the live ones, the tests a live ray (mean, p99) in the
    reference's order and in K3's (the big tier first), the share of
    lane-steps that test a row for 32 rays in pixel order in both orders and
    for K3's queue (counted by the kernel), and both orders' bounds:
    operations at K3_OPS_STAGE a test by the stage at which it ends, counted
    by trace_shadow_plain(visits=True, stages=True), or bytes (each ray's
    tmax in and hit flag out, each live ray's origin and direction, the
    offsets of the cells they use and the rows their walks reach, once), the
    larger.  With `timed`: the
    kernel alone (the C launch on prepared arguments; also at stage_rows 0
    and 512), the wrapper, the filtered kernel, the plain version and K2
    any-hit, by CUDA events, and the blocks of K3 an SM holds at each
    staging capacity; `other_k3` (another checkout's K3, _other_launch) is
    checked and timed in turns with it.  long_lists: the timed wavefront's
    longest cell list must pass the forced staging capacity (path 11's
    small grid need not).  Returns the JSON line's fields (the kernel
    alone's time, the bound of K3's order)."""
    from vulkanhybridrenderer_tpu_torch.ops import shadowgrid, traverse
    from vulkanhybridrenderer_tpu_torch.utils import build

    n = o.shape[0]
    tmin_a = torch.full((n,), tmin, dtype=torch.float32, device=o.device)
    live = tmax >= tmin_a
    cell = shadowgrid.origin_cells(sg, o[live])
    longest = int((sg.offsets[cell + 1] - sg.offsets[cell]).max()) if cell.numel() else 0
    # a staging capacity below the longest list of the timed wavefronts: the
    # rest of a list is read from device memory (at 0, every row is)
    small = 16
    _check(longest > small or not (timed and long_lists), f"{label}: the longest cell list "
           f"({longest} rows) fits the forced staging capacity of {small} rows")
    counts, ended, err = {}, {}, 0
    for filtered in (False, True) if tables is not None else (False,):
        tab = tables if filtered else None
        filt = traverse.make_alpha_hit_filter(None, tab) if filtered else None
        what = f"{'filtered ' if filtered else ''}{label}"
        k = shadowgrid.trace_shadow(sg, o, d, tmin, tmax, alpha_tables=tab, width=width)
        for big_first in (False, True):
            p, counts[filtered, big_first], ended[filtered, big_first] = (
                shadowgrid.trace_shadow_plain(sg, o, d, tmin_a, tmax, hit_filter=filt,
                                              visits=True, big_first=big_first, stages=True))
            diff = int((k != p).sum())
            err = max(err, diff)
            _check(diff == 0, f"K3 hit masks differ from its plain version on {diff} {what} "
                   f"rays (big_first={big_first})")
        k2 = traverse.trace(bvh, None, o, d, tmin_a, tmax, anyhit=True, alpha_tables=tab).hit
        k2_diff = int((k != k2).sum())
        _check(k2_diff == 0, f"K3 hit masks differ from K2 any-hit on {k2_diff} {what} rays")
        other = {form: int((shadowgrid.trace_shadow(sg, o, d, t0, tmax, alpha_tables=tab,
                                                     width=w, stage_rows=rows) != k).sum())
                 for form, t0, w, rows in (
                     ("without the width", tmin, None, shadowgrid.STAGE_ROWS),
                     ("an (R,) tmin", tmin_a, width, shadowgrid.STAGE_ROWS),
                     (f"stage_rows {small}", tmin, width, small),
                     ("stage_rows 0", tmin, width, 0))}
        _check(not any(other.values()), f"K3's other launch forms differ on {what}: {other}")
        print(f"K3 shadow_grid_trace, {what} rays: {n} ({int(live.sum())} live), hits "
              f"{int(k.sum())}; mismatched hit flags against its plain version (both orders) "
              f"0, against K2 any-hit {k2_diff}, in K3's other forms {other} (longest cell "
              f"list of a live ray {longest} rows)")
    bounds = {}
    lists = torch.clamp(sg.offsets[cell + 1] - sg.offsets[cell], max=shadowgrid.MAX_STEPS).long()
    for big_first, order in ((False, "the reference's order"), (True, "K3's order")):
        tested, at = counts[False, big_first], ended[False, big_first]
        per = tested[live].double()
        ops = sum(int(c) * price for c, price in zip(at.tolist(), K3_OPS_STAGE))
        # the bytes this order needs: tmax in and the flag out a ray, a live
        # ray's origin and direction, its cell's two offsets, and each row the
        # walks reach (a cell's longest walk, the big rows a walk reaches) once
        num_big = int(sg.num_big)
        cell_rows = (per.long() - num_big).clamp(min=0) if big_first else torch.minimum(
            per.long(), lists)
        big_rows = (per.long() if big_first else per.long() - cell_rows).clamp(0, num_big)
        reach = torch.zeros(sg.grid * sg.grid, dtype=torch.int64, device=o.device)
        reach.scatter_reduce_(0, cell, cell_rows, reduce="amax")
        nbytes = (n * 5 + int(live.sum()) * 24 + int(torch.unique(cell).numel()) * 8
                  + (int(reach.sum()) + int(big_rows.max()) if per.numel() else 0) * 48)
        b_ms, b_by = bounds[big_first] = bound(ops, nbytes)
        print(f"K3 {label} rays, {order}: tests a live ray mean "
              f"{float(per.mean()) if per.numel() else 0.0:.2f}, p99 "
              f"{float(torch.quantile(per, 0.99)) if per.numel() else 0.0:.0f}, max "
              f"{int(per.max()) if per.numel() else 0}, total {int(tested.sum())}, ending at "
              f"det / u / v / in full {at.tolist()}; lane share of 32 rays in pixel order "
              f"{_pixel_lane_share(tested, live):.4f}; bound {b_ms:.4f} ms (set by {b_by}; "
              f"{ops} operations, {nbytes} bytes; "
              f"{bound(int(tested.sum()) * K2_OPS_TRI, nbytes)[0]:.4f} ms at {K2_OPS_TRI} a "
              f"test)")
    fn = shadowgrid.load_kernel()
    out = torch.empty(n, dtype=torch.bool, device=o.device)
    stats = torch.zeros(2, dtype=torch.int64, device=o.device)
    _check(fn(*shadowgrid.launch_args(sg, o, d, tmin, tmax, out, width=width, stats=stats)) == 0,
           "the K3 launch with its lane counters failed")
    busy, steps = stats.tolist()
    print(f"K3 {label} rays: lane share of K3's queue {busy / max(steps, 1):.4f} ({busy} of "
          f"{steps} lane-steps tested a row)")
    line = dict(max_abs_err=float(err), ms=None, plain_ms=None,
                **dict(zip(("bound_ms", "bound_by"), bounds[True])))
    if timed:
        args = shadowgrid.launch_args(sg, o, d, tmin, tmax, out, width=width)
        line["ms"] = _cuda_ms(lambda: fn(*args), 20)
        staged = {rows: _cuda_ms(lambda a=shadowgrid.launch_args(
            sg, o, d, tmin, tmax, out, width=width, stage_rows=rows): fn(*a), 20)
            for rows in (0, 512)}
        wrapper_ms = _cuda_ms(lambda: shadowgrid.trace_shadow(sg, o, d, tmin, tmax, width=width),
                              20)
        k2_ms = _cuda_ms(lambda: traverse.trace(bvh, None, o, d, tmin, tmax, anyhit=True), 20)
        # what the earlier wrapper added to every call: tmin as an (R,) copy
        copy_ms = _cuda_ms(lambda: torch.as_tensor(tmin, dtype=torch.float32, device=o.device)
                           .expand(n).contiguous(), 20)
        line["plain_ms"] = _cuda_ms(lambda: shadowgrid.trace_shadow_plain(
            sg, o, d, tmin_a, tmax, big_first=True), 1)
        extra = ""
        if tables is not None:
            fargs = shadowgrid.launch_args(sg, o, d, tmin, tmax, out, alpha_tables=tables,
                                           width=width)
            k2f_ms = _cuda_ms(lambda: traverse.trace(bvh, None, o, d, tmin, tmax, anyhit=True,
                                                     alpha_tables=tables), 20)
            extra = (f", filtered kernel {_cuda_ms(lambda: fn(*fargs), 20):.4f} ms, filtered "
                     f"K2 any-hit {k2f_ms:.4f} ms")
        if other_k3 is not None:
            pfn, pparams = other_k3
            pout = torch.empty_like(out)
            pargs = _bind(pparams, _c_params(build.CSRC_DIR / "shadow_grid.cu",
                                             "shadow_grid_trace_launch"), args[:-4]
                          + (pout.data_ptr(),) + args[-3:],
                          {"tmin": tmin_a.data_ptr(), "tmax": tmax.data_ptr(),
                           "num_big": int(sg.num_big)})
            _check(fn(*args) == 0 and pfn(*pargs) == 0 and torch.equal(pout, out),
                   f"the other checkout's K3 differs on {label}")
            print(_in_turns(f"K3 {label} rays, the other checkout's kernel alone against "
                            f"this one's", lambda: pfn(*pargs), lambda: fn(*args), 20))
        occ = build.load_cuda_library("shadow_grid.cu").shadow_grid_occupancy
        occ.restype = ctypes.c_int
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        fits = []
        for rows in (0, shadowgrid.STAGE_ROWS, 512):
            for filt in (0, 1):
                blocks, smem = ctypes.c_int(), ctypes.c_int()
                _check(occ(rows, filt, o.device.index, ctypes.byref(blocks),
                           ctypes.byref(smem)) == 0, "K3's occupancy query failed")
                # the parent sized the big tier's rows by num_big on the host
                fits.append(f"stage_rows {rows}{' filtered' * filt}: {blocks.value} blocks/SM, "
                            f"{smem.value} B shared (the parent's "
                            f"{smem.value - (shadowgrid.BIG_CAP - int(sg.num_big)) * 48} B)")
        print(f"K3 {label}: blocks an SM holds at once, " + "; ".join(fits))
        print(f"K3 {label} rays: kernel alone {line['ms']:.4f} ms (stage_rows "
              f"{shadowgrid.STAGE_ROWS}; 0: {staged[0]:.4f} ms, 512: {staged[512]:.4f} ms), "
              f"wrapper {wrapper_ms:.4f} ms (the earlier wrapper also copied tmin to an (R,) "
              f"tensor: {copy_ms:.4f} ms), plain {line['plain_ms']:.4f} ms, K2 any-hit on the "
              f"same rays {k2_ms:.4f} ms{extra}; share of K3's bound "
              f"{line['bound_ms'] / line['ms']:.4f}")
    return line


def _stage_agreement(gr, cr, path):
    """Where a GPU and a CPU renderer of one configuration part: their
    intermediate resources on the next frame, side by side."""
    from vulkanhybridrenderer_tpu_torch.models import hybrid as hybrid_path
    from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt

    from vulkanhybridrenderer_tpu_torch.ops.rasterizer import triangle_setup
    from vulkanhybridrenderer_tpu_torch.utils.math3d import div

    cfg = gr.config
    if path == "forward":
        k = cfg.forward.msaa_samples
        g, c = (r.fetch_resources("Clip", "shade_tables") for r in (gr, cr))
        pg, pc = (triangle_setup(x["Clip"], r.buffers.tri_vertex, cfg.width, cfg.height).planes
                  for r, x in ((gr, g), (cr, c)))
        x = torch.linspace(-3.0, 3.0, 1 << 20)
        clip_share = float((g["Clip"].cpu() == c["Clip"]).float().mean())
        setup_share = float((pg.cpu() == pc).all(dim=1).float().mean())
        print(f"  gpu vs cpu: clip equal on {clip_share:.6f} of values, triangle setup planes "
              f"on {setup_share:.6f} of triangles; x / 3.0 equal on "
              f"{float(((x.to(gr.device) / 3.0).cpu() == x / 3.0).float().mean()):.6f} of 2^20 "
              f"values, math3d.div(x, 3.0) on "
              f"{float((div(x.to(gr.device), 3.0).cpu() == x / 3.0).float().mean()):.6f}")
        _check(clip_share == 1.0 and setup_share == 1.0,
               f"the card's triangle setup differs from the CPU's: clip {clip_share}, "
               f"setup {setup_share}")
        for alpha in (False, True):
            vg, vc = (rt.rasterize_scene_msaa(r.buffers, x["Clip"], cfg.width, cfg.height, k,
                                              alpha=alpha, tables=x["shade_tables"])
                      for r, x in ((gr, g), (cr, c)))
            print(f"  gpu vs cpu per-sample visibility, alpha {'peeled' if alpha else 'off'}: "
                  "tri id equal on " + ", ".join(
                      f"{float((a.tri_id.cpu() == b.tri_id).float().mean()):.6f}"
                      for a, b in zip(vg, vc)))
        return
    names = (hybrid_path.DEPTH, hybrid_path.SHADOW_MAP, hybrid_path.SSAO, hybrid_path.SSR)
    g, c = gr.fetch_resources(*names), cr.fetch_resources(*names)
    g = {n: v.cpu() for n, v in g.items()}
    ssao_d = (g[hybrid_path.SSAO] - c[hybrid_path.SSAO]).abs()
    hit_g, hit_c = g[hybrid_path.SSR][3], c[hybrid_path.SSR][3]
    print(f"  gpu vs cpu stages: depth equal on "
          f"{float((g[hybrid_path.DEPTH] == c[hybrid_path.DEPTH]).float().mean()):.6f}, "
          f"shadow map equal on "
          f"{float((g[hybrid_path.SHADOW_MAP] == c[hybrid_path.SHADOW_MAP]).float().mean()):.6f}"
          f" of texels; SSAO max |diff| {float(ssao_d.max()):.3g}, within 1e-4 on "
          f"{float((ssao_d <= 1e-4).float().mean()):.6f}; SSR hit flag equal on "
          f"{float((hit_g == hit_c).float().mean()):.6f} (hits {float(hit_c.mean()):.4f})")


def _breakdown(r, settings):
    """The full frame's steps one by one on one frame's resources, by CUDA
    events (5 runs each after a warm-up), and its live rays."""
    from vulkanhybridrenderer_tpu_torch.models import hybrid as hybrid_path
    from vulkanhybridrenderer_tpu_torch.ops import (
        gbuffer, raygen, rasterizer_tiled as rt, rt_shade, svgf, traverse,
    )
    from vulkanhybridrenderer_tpu_torch.ops.rasterizer import triangle_setup

    res = r.fetch_resources("pfd", "Clip", "BVH", "shade_tables", "TriRows",
                            hybrid_path.DEPTH, hybrid_path.NORMALS, hybrid_path.MOTION_MR,
                            hybrid_path.RT_SHADOW_AO)
    b, cfg = r.buffers, r.config
    w, h = cfg.width, cfg.height
    pfd, bvh, tables = res["pfd"], res["BVH"], res["shade_tables"]
    depth, normals = res[hybrid_path.DEPTH], res[hybrid_path.NORMALS]
    setup = triangle_setup(res["Clip"], b.tri_vertex, w, h)
    opaque = b.materials.alpha_mask[b.tri_prim.long()] != 1
    bins = rt.bin_triangles(setup, w, h, include=opaque)
    vis = rt.rasterize_scene(b, res["Clip"], w, h, tables=tables)
    rays = raygen.Wavefronts(pfd, depth, normals, settings, ao_rays=cfg.ao_rays)
    rec = traverse.trace(bvh, None, rays.origin, rays.refl_dir, raygen.SHADOW_TMIN,
                         rays.refl_tmax, anyhit=False)
    integrated, _ = svgf.temporal(normals, res[hybrid_path.MOTION_MR],
                                  res[hybrid_path.RT_SHADOW_AO], r.temporal_state)
    steps = {
        "triangle setup": lambda: triangle_setup(res["Clip"], b.tri_vertex, w, h),
        "opaque binning": lambda: rt.bin_triangles(setup, w, h, include=opaque),
        "K1a (opaque stream)": lambda: rt.raster_tiles(setup.planes, bins, w, h),
        "alpha peel": lambda: rt.rasterize_alpha_peeled(b, setup, w, h, tables,
                                                        rounds=cfg.alpha_peel_rounds),
        "resolve": lambda: gbuffer.resolve_gbuffer(b, tables, res["TriRows"], vis, pfd),
        "ray generation": lambda: raygen.Wavefronts(pfd, depth, normals, settings,
                                                    ao_rays=cfg.ao_rays),
        "K2 shadow": lambda: traverse.trace(bvh, None, rays.origin, rays.shadow_dir,
                                            raygen.SHADOW_TMIN, rays.shadow_tmax, anyhit=True),
        "K2 AO": lambda: traverse.trace(bvh, None, rays.origin.repeat(cfg.ao_rays, 1), rays.ao_dir,
                                        raygen.SHADOW_TMIN, rays.ao_tmax.repeat(cfg.ao_rays),
                                        anyhit=True),
        "K2 reflection": lambda: traverse.trace(bvh, None, rays.origin, rays.refl_dir,
                                                raygen.SHADOW_TMIN, rays.refl_tmax,
                                                anyhit=False),
        "reflection shading": lambda: rt_shade.reflection_hit_shade(
            b, tables, res["TriRows"], pfd, rec.tri, rec.u, rec.v),
        "SVGF temporal": lambda: svgf.temporal(normals, res[hybrid_path.MOTION_MR],
                                               res[hybrid_path.RT_SHADOW_AO], r.temporal_state),
        "SVGF one a-trous iteration": lambda: svgf.atrous_iteration(integrated, normals, 1),
    }
    live = {"shadow": int((rays.shadow_tmax >= raygen.SHADOW_TMIN).sum()),
            "AO": int((rays.ao_tmax >= raygen.SHADOW_TMIN).sum()) * cfg.ao_rays,
            "reflection": int((rays.refl_tmax >= raygen.SHADOW_TMIN).sum())}
    print(f"live rays per wavefront (of {w * h} pixels; AO {cfg.ao_rays} rays each): {live}")
    print("breakdown ms: " + ", ".join(f"{k} {_cuda_ms(fn, 5):.3f}" for k, fn in steps.items()))


def _profile(r, label: str, frames: int = 5, before=None) -> None:
    """torch.profiler over `frames` frames of renderer `r` (before(r) ahead
    of each, as drive's): device busy share of the window and the largest
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    r.render_frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            if before is not None:
                before(r)
            r.render_frame(sync=False)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device time: only the kernels' own events, not the aten ops above them
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    print(f"profile: {frames} {label} frames, window {window_ms:.3f} ms (profiler on), device "
          f"kernel time {busy_ms:.3f} ms ({busy_ms / frames:.3f} ms/frame), busy share "
          f"{busy_ms / window_ms:.4f}")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=15))


if __name__ == "__main__":
    sys.exit(main())

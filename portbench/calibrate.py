"""Readings for the check's limits: the port's frames against the reference
on many seeds, and the control's (the reference one precision lower, in the
program's place), in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control <n>] [--render KEY=JSON ...]

For each seed a fresh renderer flies that seed's path as a run does (set-up,
then the loop until the check's frames, drawn from the seed as a run draws
them) and is freed; the reference renders the same frames as a run's check
does, at float32 and, as the control on the first ``--control`` seeds
(default all), at bfloat16 (``reference/render.py``'s ``lowp``).
One JSON line a seed: the check's numbers of the port and of the control.
Run from the root of a checkout on a machine with the cell's cards.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=None,
                   help="seeds, from the first, that also read the control")
    p.add_argument("--render", nargs="*", default=[], metavar="KEY=JSON",
                   help="render settings put in place of the cell's (a witness run, such "
                        "as bvh_dtype=\"f32\"), for the port and the reference alike")
    args = p.parse_args(argv)
    import torch

    from portbench.lib import check, harness, spec

    root = Path.cwd()
    harness.cache_env(root)
    cell = spec.load_cell(args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    settings = {k: json.loads(v) for k, v in (s.split("=", 1) for s in args.render)}
    ref = None
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        for k, seed in enumerate(args.seeds):
            run = harness.Run(cell, seed, torch.cuda.device_count(), Path(tmp),
                              settings=settings or None)
            run.warm_up(int(cell.workload.get("warm_frames", 3)))
            sample = check.Sample(at=harness.window_sample_at(cell, seed),
                                  frames=int(cell.workload["check"]["frames"]))
            run.loop(frames=sample.at, sample=sample)
            first, outs = check.sampled(run, sample)
            sample.outs = []
            check.release(run)
            if ref is None:
                ref = check.make_reference(run, torch.device("cuda", 0))
            t1 = time.perf_counter()
            refs = check.reference_frames(ref, run.fly, first, len(outs))
            got = check.compare(outs, refs)
            t2 = time.perf_counter()
            low = None
            if args.control is None or k < args.control:
                low = check.compare(check.reference_frames(ref, run.fly, first, len(outs),
                                                           lowp=True), refs)
            print(json.dumps({"cell": cell.name, "render": args.render, "seed": seed,
                              "first_frame": first,
                              "program": check.worst(got),
                              "control": low and check.worst(low),
                              "program_frames": got, "control_frames": low,
                              "reference_s": t2 - t1, "card": torch.cuda.get_device_name(0)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))

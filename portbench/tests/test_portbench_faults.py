"""The check fails a broken timed path: the harness's run and check on the
CPU at a tiny size, with the frame's path broken underneath, once for each
fault a cell can have (the gather left out over a mesh:
test_portbench_mesh.py); and the control, the reference one precision
lower, fails it too."""
import pytest
from conftest import TINY, checked, tiny_run

from portbench.lib import check


def state_unchanged():
    """Each frame hands on the temporal state it was given: the SVGF history
    never advances past the first frame the fault sees."""
    held = {}

    def fault(run, out):
        r = run.renderer
        if "state" not in held:
            held["state"] = r.temporal_state
        r.temporal_state = held["state"]
        return out
    return fault


def half_left_out(run, out):
    """The lower half of the frame's rows is never rendered."""
    out = out.clone()
    out[:, out.shape[1] // 2:, :] = 0.0
    return out


def stale_frame():
    """Each frame's answer is altered where it is produced: the previous
    frame's output is returned in its place."""
    held = {}

    def fault(run, out):
        prev = held.get("out", out)
        held["out"] = out
        return prev
    return fault


FAULTS = {
    "state unchanged": (state_unchanged, ("realglb-hybrid-fly",)),
    "half left out": (lambda: half_left_out, tuple(TINY)),
    "stale frame": (stale_frame, tuple(TINY)),
}
CASES = [(f, c) for f, (_, cells) in FAULTS.items() for c in sorted(cells)]


@pytest.mark.parametrize("fault,cell", CASES)
def test_a_broken_timed_path_is_not_correct(fault, cell, tmp_path):
    v = checked(tiny_run(cell, 2**31 + 77, tmp_path, fault=FAULTS[fault][0]()))
    assert not v["correct"], v
    assert v["failed"] > 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_not_correct(cell, tmp_path):
    """The reference in the program's place at bfloat16 (its images, rays
    and hit attributes rounded) against the reference at float32."""
    run = tiny_run(cell, 2**31 + 91, tmp_path)
    sample = check.Sample(at=1, frames=int(run.cell.workload["check"]["frames"]))
    run.loop(frames=4, sample=sample)
    first, outs = check.sampled(run, sample)
    check.release(run)
    reference = check.make_reference(run, "cpu")
    ref = check.reference_frames(reference, run.fly, first, len(outs))
    low = check.reference_frames(reference, run.fly, first, len(outs), lowp=True)
    v = check.verdict(check.compare(low, ref), run.cell.workload["check"]["limits"])
    assert not v["correct"], v

"""The flown camera: a function of the seed and the frame index only,
periodic, different between seeds, and inside both scenes."""
import numpy as np
import pytest

from portbench.lib.fly import Fly, view_forward



def params():
    import json
    from pathlib import Path

    return json.loads((Path(__file__).resolve().parents[1] / "traffic" / "fly.json").read_text())


def make(seed, cam=((0.0, 3.0, 10.5), 0.0, 0.0), forward=(0.0, 0.0, -1.0)):
    pos, yaw, pitch = cam
    return Fly(params(), seed, pos, yaw, pitch, np.asarray(forward))


SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_pose_is_a_function_of_seed_and_index(seed):
    a, b = make(seed), make(seed)
    for i in (0, 1, 17, 239, 240, 1000):
        assert a.pose(i) == b.pose(i)
    # asking out of order changes nothing: no state between calls
    assert [a.pose(i) for i in (5, 3, 5)][0] == a.pose(5)


@pytest.mark.parametrize("seed", SEEDS)
def test_poses_repeat_every_period(seed):
    f = make(seed)
    assert f.period == 240
    for i in range(0, 480, 7):
        assert f.pose(i) == f.pose(i + 240)
    assert len({f.pose(i) for i in range(240)}) > 200


def test_seeds_give_different_paths():
    paths = [tuple(make(s).pose(i) for i in range(24)) for s in SEEDS]
    assert len(set(paths)) == len(SEEDS)


def test_walk_is_w_then_s_two_units_out_and_back():
    f = make(3)
    walked = [f.walk(j) for j in range(48)]
    assert walked[0] == 0.0 and walked[12] == pytest.approx(2.0) and walked[24] == 0.0
    assert all(b > a for a, b in zip(walked[:12], walked[1:13]))
    assert all(b < a for a, b in zip(walked[12:24], walked[13:25]))


def test_a_period_visits_the_same_look_range_for_every_seed():
    for s in SEEDS:
        f = make(s)
        yaws = [f.pose(i).yaw for i in range(240)]
        assert max(yaws) == pytest.approx(0.5, abs=1e-3)
        assert min(yaws) == pytest.approx(-0.5, abs=1e-3)


def _world_box(ref):
    pos = ref.world
    return pos.amin(0).numpy(), pos.amax(0).numpy()


def _scenes(tmp_path):
    from portbench.inputs import procedural, sponza_class_glb
    from portbench.lib import scenes
    from portbench.reference import render

    made = {"realglb": sponza_class_glb.make({"scale": 0.1}, tmp_path),
            "sponzaproxy": procedural.make({"scene": "sponza_proxy"}, tmp_path)}
    return {k: render.Reference(scenes.reference_scene(m), {"hybrid": {"shadow_mode": "OFF"}},
                                "hybrid", 64, 36, "cpu") for k, m in made.items()}


def test_path_stays_inside_both_scenes(tmp_path):
    for name, ref in _scenes(tmp_path).items():
        lo, hi = _world_box(ref)
        cam = ref.sc.camera
        for seed in SEEDS:
            f = Fly(params(), seed, cam.position, cam.yaw, cam.pitch, view_forward(cam.view()))
            for i in range(240):
                p = np.asarray(f.pose(i).position)
                assert np.all(p > lo + 0.5) and np.all(p < hi - 0.5), (name, seed, i, p)

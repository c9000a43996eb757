"""The port's kernel-build cache (utils/build.py): row 2 of the TPU kernel
table, the counterpart of tests/test_compile_cache.py's call-site-independent
Pallas payload.

The property held: one library for a given compiler command line and source
bytes, whoever asks - not the working directory, the calling module or the
caller's line.  A changed source byte or flag gives a new library; a failed
build raises with the compiler's output.  The compiler here is a fake
(``[sys.executable, fake_cc.py]``) that copies its sources to ``-o``, so the
test needs no nvcc; the toy kernel itself (csrc/toy_scale.cu) is built and
held against ``x * 2`` by chip_smoke.py on the card.  No tolerance: paths and
bytes are compared exactly.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu_torch.utils import build

FAKE_CC = textwrap.dedent(
    """
    import sys
    args = sys.argv[1:]
    if "--fail" in args:
        print("fake_cc: error: refusing to build", file=sys.stderr)
        sys.exit(3)
    out = args[args.index("-o") + 1]
    srcs = [a for a in args[args.index("-o") + 2:]]
    with open(out, "wb") as f:
        for s in srcs:
            f.write(open(s, "rb").read())
    """
)

CALLER = textwrap.dedent(
    """
    from vulkanhybridrenderer_tpu_torch.utils import build


    def ask(compiler, sources):
        # a second caller module, asking from a line of its own
        return build.build_library("toy", compiler, sources)
    """
)


@pytest.fixture
def setup(tmp_path, monkeypatch):
    cc = tmp_path / "fake_cc.py"
    cc.write_text(FAKE_CC)
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    (src_dir / "toy.cu").write_text("o[i] = x[i] * 2.0f;\n")
    (tmp_path / "caller_mod.py").write_text(CALLER)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return dict(tmp=tmp_path, compiler=[sys.executable, str(cc), "-O3"],
                src=src_dir / "toy.cu", out=tmp_path / "_build")


def test_one_build_whoever_asks(setup, monkeypatch):
    s = setup
    before = build.build_library.compiles
    monkeypatch.chdir(s["tmp"])
    first = build.build_library("toy", s["compiler"], [s["src"]])
    assert first.parent == s["out"] and first.read_bytes() == s["src"].read_bytes()
    assert build.build_library.compiles == before + 1
    # another working directory, a relative source path
    monkeypatch.chdir(s["src"].parent)
    assert build.build_library("toy", s["compiler"], ["toy.cu"]) == first
    # another module, from another line
    monkeypatch.syspath_prepend(str(s["tmp"]))
    import caller_mod

    assert caller_mod.ask(s["compiler"], [s["src"]]) == first
    assert build.build_library.compiles == before + 1  # no second compile
    # another process in another directory
    code = ("from pathlib import Path; from vulkanhybridrenderer_tpu_torch.utils import build; "
            f"build.BUILD_DIR = Path({str(s['out'])!r}); "
            f"print(build.build_library('toy', {s['compiler']!r}, [{str(s['src'])!r}])); "
            "print(build.build_library.compiles)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=s["out"], text=True,
                          capture_output=True, check=True,
                          env={**os.environ, "PYTHONPATH": str(build.REPO_DIR)})
    path, compiles = proc.stdout.split()
    assert path == str(first) and compiles == "0"
    assert sorted(p.name for p in s["out"].glob("*.so")) == [first.name]


def test_a_byte_or_a_flag_rebuilds(setup):
    s = setup
    first = build.build_library("toy", s["compiler"], [s["src"]])
    flagged = build.build_library("toy", s["compiler"] + ["-g"], [s["src"]])
    s["src"].write_text("o[i] = x[i] * 2.0f; \n")
    edited = build.build_library("toy", s["compiler"], [s["src"]])
    assert len({first, flagged, edited}) == 3
    assert edited.read_bytes() == s["src"].read_bytes()


def test_failed_build_raises_with_output(setup):
    s = setup
    with pytest.raises(RuntimeError, match="refusing to build"):
        build.build_library("toy", s["compiler"] + ["--fail"], [s["src"]])
    assert not list(s["out"].glob("*.so")) and not list(s["out"].glob("*.tmp"))


def test_toy_scale_plain_on_cpu():
    """On a CPU tensor the toy kernel's wrapper runs its plain version,
    exactly x * 2, and launches nothing."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 256), np.float32))
    before = build.toy_scale.launches
    assert torch.equal(build.toy_scale(x), x * 2.0)
    assert build.toy_scale.launches == before
    with pytest.raises(ValueError):
        build.toy_scale(x.to(torch.float64).to("meta"))


@pytest.mark.parametrize("n", [0, 1, 3, 5, 65_539])
@pytest.mark.parametrize("view", ["fresh", "misaligned"])
def test_toy_scale_lengths_and_views(n, view):
    """toy_scale on the CPU equals x * 2 bit for bit at the kernel's edge
    lengths (no float4, a scalar tail, an odd length) and on a contiguous
    view whose data is not 16-byte aligned (x[1:])."""
    base = torch.from_numpy(np.random.default_rng(n).standard_normal(n + 1, np.float32))
    x = base[1:] if view == "misaligned" else base[:n].clone()
    assert x.is_contiguous() and x.numel() == n
    assert torch.equal(build.toy_scale(x), x * 2.0)


@pytest.mark.parametrize("bad", ["float64", "non-contiguous", "another device"])
def test_toy_scale_raises(bad):
    """What the kernel does not take raises before either version runs: a
    float64 or a non-contiguous CPU tensor (the checks the CUDA path makes
    too), a float32 contiguous tensor on a device that is neither the CPU
    nor CUDA."""
    x = torch.zeros((8, 8))
    x = {"float64": x.double(), "non-contiguous": x.t(), "another device": x.to("meta")}[bad]
    before = build.toy_scale.launches
    with pytest.raises(ValueError, match="contiguous float32 CPU or CUDA tensor"):
        build.toy_scale(x)
    assert build.toy_scale.launches == before

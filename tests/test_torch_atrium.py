"""The port's Atrium (scene/sample_asset.build_sample_glb, written and read
by the port) in the forward path at 96x96 with shadow_map_size=128, as
test_real_asset.py renders the reference's: against the golden
tests/goldens/atrium_forward.npy, and against the reference's frame of the
same asset computed without jit.

The golden (RMSE <= 2e-3 after clamping, test_real_asset.py's bound) holds
on every pixel but the Atrium's near depth ties: 12 pixels where the floor
and the columns' bottom faces, coplanar at y = 0, z-fight, and the last bits
of each triangle's setup decide which shows (rasterizer_tiled.depth_ties,
from the port's own geometry, before any comparison; at most 0.5% of the
frame may be such ties).  Measured: RMSE 4.2e-5 over the other 9,204
pixels; over all pixels 0.004856, the same as the reference's own frame
under jax.disable_jit() (0.004856): the golden was made by the jitted
reference, whose fused multiply-adds tip those ties the other way.  Against
that unjitted reference frame every pixel is within 1e-4 (measured max
1.3e-5).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import gltf as jgltf
from vulkanhybridrenderer_tpu.scene import sample_asset as jasset
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import gltf as pgltf
from vulkanhybridrenderer_tpu_torch.scene import sample_asset as passet

torch.set_num_threads(2)
GOLDEN = Path(__file__).parent / "goldens" / "atrium_forward.npy"
N = 96


@pytest.fixture(scope="module")
def port_frame(tmp_path_factory):
    path = tmp_path_factory.mktemp("atrium") / "Atrium.glb"
    passet.build_sample_glb(path)
    r = prenderer.Renderer(pgltf.load_scene(path),
                           pcfg.RenderConfig(width=N, height=N, shadow_map_size=128),
                           path="forward", device="cpu")
    img = r.render_frame().numpy()
    ties = rt.depth_ties(r.buffers, r.fetch_resources("Clip")["Clip"], N, N).numpy()
    return img, ties


def test_atrium_forward_golden(port_frame):
    img, ties = port_frame
    assert np.isfinite(img).all()
    assert 0 < ties.sum() <= 0.005 * N * N, ties.sum()
    golden = np.load(GOLDEN).astype(np.float32)
    sq = (np.clip(img, 0, 1) - np.clip(golden, 0, 1)) ** 2
    err = float(np.sqrt(sq[:, ~ties].mean()))
    print(f"atrium golden RMSE: {err:.6g} over {int((~ties).sum())} pixels, "
          f"{float(np.sqrt(sq.mean())):.6g} over all")
    assert err <= 2e-3, err


def test_atrium_forward_equals_reference_unfused(port_frame, tmp_path):
    path = tmp_path / "Atrium.glb"
    jasset.build_sample_glb(path)
    jr = jrenderer.Renderer(jgltf.load_scene(path),
                            jcfg.RenderConfig(width=N, height=N, shadow_map_size=128),
                            path="forward")
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    with jax.disable_jit():
        want = np.asarray(jr.render_frame())
    img, _ = port_frame
    d = np.abs(img - want).max(axis=0)
    assert d.max() <= 1e-4, d.max()

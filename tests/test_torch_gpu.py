"""K1 and K2 on a CUDA device against their plain PyTorch versions.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips when there is none. Run on a GPU machine with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest`` (the
suite's conftest imports JAX, which this file does not need).

Tolerances: K1 floats within rtol 1e-5 and integers equal on all but
1e-4 of the splats (off by at most 1); K2 planes within 2e-3 max abs and
1e-5 mean abs (running product vs cumprod), exec equal on ≥ 99.9% of tiles.
"""

import numpy as np
import pytest
import torch

from ray_eater_tpu_torch.bench_knobs import flythrough_camera
from ray_eater_tpu_torch.models.gaussians import random_cloud
from ray_eater_tpu_torch.ops import gs

pytestmark = pytest.mark.gpu

W, H = 480, 270


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def scene():
    dev = _cuda()
    cloud = random_cloud(100_000, seed=1, extent=1.0,
                         scale_range=(0.004, 0.02), device=dev)
    return cloud, *flythrough_camera(0.3, W, H, device=dev)


def test_k1_matches_plain(scene):
    cloud, view, proj = scene
    scal = gs._project_scalars(view, proj, W, H, 0.05,
                               float(gs.level1_max_radius()))
    args = (cloud.means, cloud.scales, cloud.quats, cloud.opacities, scal)
    k, p = gs._project_k1(*args), gs._project_plain(*args)
    both = torch.isfinite(k[5]) & torch.isfinite(p[5])
    torch.testing.assert_close(k[:6][:, both], p[:6][:, both], rtol=1e-5,
                               atol=1e-6)
    idiff = (k[6:9] - p[6:9]).abs()
    assert float(idiff.max()) <= 1
    n = cloud.num_splats
    assert int(((idiff > 0).any(0) | (torch.isfinite(k[5])
                                      != torch.isfinite(p[5]))).sum()) \
        <= 1e-4 * n


@pytest.mark.parametrize("mpt", [None, 176])
@pytest.mark.parametrize("tile_w", [32, 128])
def test_k2_matches_plain(scene, mpt, tile_w):
    cloud, view, proj = scene
    lay = gs._frame_layout(cloud, view, proj, W, H, tile_w=tile_w,
                           max_splats_per_tile=mpt)
    b = lay.binned
    args = (lay.records, b.row_begin, b.row_end, lay.ntx, lay.nty, tile_w)
    (pk, ek), (pp, ep) = gs._composite_call(*args), gs._composite_plain(*args)
    err = (pk - pp).abs()
    assert float(err.max()) <= 2e-3 and float(err.mean()) <= 1e-5
    assert float((ek == ep).float().mean()) >= 0.999


def test_render_is_finite_and_counts_launches(scene):
    from ray_eater_tpu_torch.ops import _cuda
    cloud, view, proj = scene
    _cuda.reset_launches()
    img = gs.render_gaussians(cloud, view, proj, W, H, tile_w=32,
                              max_splats_per_tile=176)
    assert img.shape == (H, W, 3) and img.is_cuda
    assert bool(torch.isfinite(img).all())
    assert _cuda.launches == {"k1_project": 1, "k2_composite": 1}
    assert np.isfinite(img.cpu().numpy()).all()

"""The CUDA march kernel (csrc/march.cu) against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one. On
the card, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are 64x64 with 32 samples, as in tests/test_torch_shadows.py. Bars
are the repo's kernel-test bars (tests/test_shadows_pallas.py:44-51):
sentinel agreement on >= 0.9999 of pixels, 0.9999-quantile |d| < 1e-3, mean
|d| < 1e-4 (a knife-edge sample may round the other way).
"""

import dataclasses

import numpy as np
import pytest
import torch

from geomconsistentfr_torch.config import RenderConfig
from geomconsistentfr_torch.ops import shadows, shadows_cuda
from geomconsistentfr_torch.ops.geometry import l2_normalize
from geomconsistentfr_torch.render import render

pytestmark = pytest.mark.cuda

SMALL = dict(img_height=64, img_width=64, num_sample_points=32, t_start=0.025, t_stop=0.185)
LIGHTS = np.asarray(
    [[1203.9, 1605.2, 3475.3], [-2407.8, 401.3, 3170.3], [5.0, -3.0, 20.0], [600.0, -300.0, 3000.0]],
    np.float32,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the march kernel has no CPU mode")
    return torch.device("cuda")


def scene(dev, seed=0):
    rng = np.random.default_rng(seed)
    depth = (rng.normal(size=(4, 64, 64)) * 30).astype(np.float32)
    yy, xx = np.mgrid[:64, :64]
    face = ((xx - 28) / 18.0) ** 2 + ((yy - 36) / 22.0) ** 2 <= 1.0
    mask = (face & (rng.uniform(size=(4, 64, 64)) > 0.05)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (depth, mask, LIGHTS)]


def assert_march_close(got, want):
    big_w, big_g = want >= 1e5, got >= 1e5
    assert (big_w == big_g).float().mean().item() >= 0.9999
    diff = (got - want).abs()[~(big_w | big_g)].double().cpu()
    assert torch.quantile(diff, 0.9999).item() < 1e-3, diff.max().item()
    assert diff.mean().item() < 1e-4


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("cull", [0, 64, 32, 16], ids=["cull_off", "cull_row", "cull_col32", "cull_col16"])
@pytest.mark.parametrize("veto", ["onehot", "bilinear"])
def test_kernel_matches_plain(dev, veto, cull, gate):
    depth, mask, light = scene(dev)
    cfg = RenderConfig(**SMALL, shadow_mask_gather=veto, shadow_bias_gate=gate,
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    before = shadows_cuda.LAUNCHES
    got = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg)
    torch.cuda.synchronize()
    assert shadows_cuda.LAUNCHES == before + 1
    assert_march_close(got, shadows.ray_march_min_distance_batch(depth, mask, light, cfg))


def test_kernel_ts_slice(dev):
    depth, mask, light = scene(dev, seed=1)
    cfg = RenderConfig(**SMALL)
    ts = shadows.sample_ts(cfg).astype(np.float32)[5:21]
    got = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, ts)
    assert_march_close(got, shadows.ray_march_min_distance_batch(depth, mask, light, cfg, ts))


def test_render_on_the_card_always_launches_the_kernel(dev):
    depth, mask, light = scene(dev)
    cfg = RenderConfig(**SMALL)
    args = (torch.rand((4, 64, 64, 3), device=dev), depth, torch.zeros((4, 4), device=dev), mask)
    before = shadows_cuda.LAUNCHES
    out = render(*args, cfg, target_light=light)
    assert shadows_cuda.LAUNCHES == before + 1
    want = shadows.ray_march_min_distance_batch(depth, mask, cfg.light_distance * l2_normalize(light, dim=-1), cfg)
    assert_march_close(out.min_distance, want)
    with pytest.raises(ValueError):
        render(*args, dataclasses.replace(cfg, use_pallas_shadows=False), target_light=light)
    assert shadows_cuda.LAUNCHES == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    depth, mask, light = scene(dev)
    cfg = RenderConfig(**SMALL)
    with pytest.raises(TypeError):
        shadows_cuda.ray_march_min_distance_cuda(depth.double(), mask, light, cfg)
    with pytest.raises(ValueError):
        shadows_cuda.ray_march_min_distance_cuda(depth.transpose(1, 2), mask, light, cfg)
    with pytest.raises(ValueError):
        shadows_cuda.ray_march_min_distance_cuda(depth, mask, light[:, :2].contiguous(), cfg)
    with pytest.raises(ValueError):
        shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, dataclasses.replace(cfg, img_width=128))
    with pytest.raises(NotImplementedError):
        shadows_cuda.ray_march_min_distance_cuda(depth.requires_grad_(), mask, light, cfg)

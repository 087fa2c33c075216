"""The CUDA march kernels (csrc/march.cu) against their plain PyTorch versions, on the card.

K1 is the march, K2 the march with the argmin, K3 the draft tier's refine.
Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one. On
the card, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are 64x64 with 32 samples, as in tests/test_torch_shadows.py; the draft
tests pool them at scale 2 (32x32, 16 samples at stride 2) and refine 8
offsets at 64x64. Bars are the repo's kernel-test bars
(tests/test_shadows_pallas.py:44-51): sentinel agreement on >= 0.9999 of
pixels, 0.9999-quantile |d| < 1e-3, mean |d| < 1e-4 (a knife-edge sample may
round the other way), and K2's winning index equal on >= 0.9999 of pixels.
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
DRAFT = dict(SMALL, shadow_resolution_scale=2, shadow_refine_halfwidth=4, shadow_lowres_t_stride=2)
CULLS = dict(argvalues=[0, 64, 32, 16], ids=["cull_off", "cull_row", "cull_col32", "cull_col16"])
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


def launches_since(before):
    return {k: v - before[k] for k, v in shadows_cuda.LAUNCHES.items()}


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("cull", **CULLS)
@pytest.mark.parametrize("veto", ["onehot", "bilinear"])
def test_kernel_matches_plain(dev, veto, cull, gate):
    depth, mask, light = scene(dev)
    cfg = RenderConfig(**SMALL, shadow_mask_gather=veto, shadow_bias_gate=gate,
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg)
    torch.cuda.synchronize()
    assert launches_since(before) == {"march": 1, "march_argmin": 0, "refine": 0}
    assert_march_close(got, shadows.ray_march_min_distance_batch(depth, mask, light, cfg))


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("cull", [0, 64, 16], ids=["cull_off", "cull_row", "cull_col16"])
@pytest.mark.parametrize("veto", ["onehot", "bilinear"])
def test_argmin_kernel_matches_plain(dev, veto, cull, gate):
    depth, mask, light = scene(dev, seed=2)
    cfg = RenderConfig(**SMALL, shadow_mask_gather=veto, shadow_bias_gate=gate,
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    before = dict(shadows_cuda.LAUNCHES)
    got_d, got_t = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, return_argmin_t=True)
    torch.cuda.synchronize()
    assert launches_since(before) == {"march": 0, "march_argmin": 1, "refine": 0}
    want_d, want_t = shadows.ray_march_min_distance_batch(depth, mask, light, cfg, return_argmin_t=True)
    assert_march_close(got_d, want_d)
    assert (got_t == want_t).float().mean().item() >= 0.9999
    assert torch.equal(got_d, shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg))


def test_argmin_kernel_on_pooled_inputs_and_ts_slice(dev):
    depth, mask, light = scene(dev, seed=3)
    cfg = RenderConfig(**DRAFT, shadow_mask_gather="bilinear", shadow_mask_cull=True)
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light, cfg)
    for ts in (None, shadows.sample_ts(m_cfg).astype(np.float32)[3:11]):
        got_d, got_t = shadows_cuda.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, ts,
                                                                return_argmin_t=True)
        want_d, want_t = shadows.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, ts,
                                                              return_argmin_t=True)
        assert_march_close(got_d, want_d)
        assert (got_t == want_t).float().mean().item() >= 0.9999


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("cull", **CULLS)
@pytest.mark.parametrize("veto", ["onehot", "bilinear"])
def test_refine_kernel_matches_plain(dev, veto, cull, gate):
    depth, mask, light = scene(dev, seed=4)
    cfg = RenderConfig(**DRAFT, shadow_mask_gather=veto, shadow_bias_gate=gate,
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light, cfg)
    _, t_star = shadows.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    t_map = shadows.upsample_tstar_nn(t_star, cfg)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map, cfg)
    torch.cuda.synchronize()
    assert launches_since(before) == {"march": 0, "march_argmin": 0, "refine": 1}
    assert_march_close(got, shadows.refine_min_distance_batch(depth, mask, light, t_map, cfg))
    offsets = shadows.refine_offsets(cfg)[1:6]
    assert_march_close(shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map, cfg, offsets),
                       shadows.refine_min_distance_batch(depth, mask, light, t_map, cfg, offsets))


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
    before = dict(shadows_cuda.LAUNCHES)
    out = render(*args, cfg, target_light=light)
    assert launches_since(before) == {"march": 1, "march_argmin": 0, "refine": 0}
    want = shadows.ray_march_min_distance_batch(depth, mask, cfg.light_distance * l2_normalize(light, dim=-1), cfg)
    assert_march_close(out.min_distance, want)
    with pytest.raises(ValueError):
        render(*args, dataclasses.replace(cfg, use_pallas_shadows=False), target_light=light)
    assert launches_since(before) == {"march": 1, "march_argmin": 0, "refine": 0}


@pytest.mark.parametrize("halfwidth", [4, 0], ids=["refine", "upscale"])
def test_draft_render_launches_the_draft_kernels(dev, halfwidth):
    depth, mask, light = scene(dev, seed=5)
    cfg = RenderConfig(**dict(DRAFT, shadow_refine_halfwidth=halfwidth, shadow_lowres_t_stride=1),
                       shadow_mask_gather="bilinear", shadow_mask_cull=True, shadow_col_chunk=64)
    args = (torch.rand((4, 64, 64, 3), device=dev), depth, torch.zeros((4, 4), device=dev), mask)
    before = dict(shadows_cuda.LAUNCHES)
    out = render(*args, cfg, target_light=light)
    torch.cuda.synchronize()
    want_launches = {"march": 0, "march_argmin": 1, "refine": 1} if halfwidth else {"march": 1, "march_argmin": 0, "refine": 0}
    assert launches_since(before) == want_launches
    lp = cfg.light_distance * l2_normalize(light, dim=-1)
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, lp, cfg)
    if halfwidth:
        _, t_star = shadows.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
        want = shadows.refine_min_distance_batch(depth, mask, lp, shadows.upsample_tstar_nn(t_star, cfg), cfg)
    else:
        want = shadows.upscale_min_distance(shadows.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg), cfg)
    assert_march_close(out.min_distance, want)
    assert torch.isfinite(out.rendered).all()


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
        shadows_cuda.ray_march_min_distance_cuda(depth.clone().requires_grad_(), mask, light, cfg,
                                                 return_argmin_t=True)
    t_map = torch.full_like(depth, 0.1)
    with pytest.raises(TypeError):
        shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map.double(), cfg)
    with pytest.raises(ValueError):
        shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map[:2].contiguous(), cfg)
    with pytest.raises(ValueError):
        shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map.cpu(), cfg)
    with pytest.raises(ValueError):
        shadows_cuda.refine_min_distance_cuda(depth[:, :, :48].contiguous(), mask[:, :, :48].contiguous(), light,
                                              t_map[:, :, :48].contiguous(), dataclasses.replace(cfg, img_width=48))
    with pytest.raises(NotImplementedError):
        shadows_cuda.ray_march_min_distance_cuda(depth.requires_grad_(), mask, light, cfg)

"""The CUDA march kernels (csrc/march.cu) against their plain PyTorch versions, on the card.

K1 is the march, K2 the march with the argmin, K3 the draft tier's refine,
march_grad the backward of the training march (K2 forward, march_grad
backward; the last tests drive it through render() and a train step).
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
    assert launches_since(before) == {"march": 1, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0}
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
    assert launches_since(before) == {"march": 0, "march_argmin": 1, "refine": 0, "march_grad": 0, "march_sp": 0}
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
    assert launches_since(before) == {"march": 0, "march_argmin": 0, "refine": 1, "march_grad": 0, "march_sp": 0}
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
    assert launches_since(before) == {"march": 1, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0}
    want = shadows.ray_march_min_distance_batch(depth, mask, cfg.light_distance * l2_normalize(light, dim=-1), cfg)
    assert_march_close(out.min_distance, want)
    with pytest.raises(ValueError):
        render(*args, dataclasses.replace(cfg, use_pallas_shadows=False), target_light=light)
    assert launches_since(before) == {"march": 1, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0}


@pytest.mark.parametrize("halfwidth", [4, 0], ids=["refine", "upscale"])
def test_draft_render_launches_the_draft_kernels(dev, halfwidth):
    depth, mask, light = scene(dev, seed=5)
    cfg = RenderConfig(**dict(DRAFT, shadow_refine_halfwidth=halfwidth, shadow_lowres_t_stride=1),
                       shadow_mask_gather="bilinear", shadow_mask_cull=True, shadow_col_chunk=64)
    args = (torch.rand((4, 64, 64, 3), device=dev), depth, torch.zeros((4, 4), device=dev), mask)
    before = dict(shadows_cuda.LAUNCHES)
    out = render(*args, cfg, target_light=light)
    torch.cuda.synchronize()
    want_launches = ({"march": 0, "march_argmin": 1, "refine": 1, "march_grad": 0, "march_sp": 0} if halfwidth
                     else {"march": 1, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0})
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
        shadows_cuda.ray_march_min_distance_cuda(depth.clone().requires_grad_(), mask, light,
                                                 dataclasses.replace(cfg, shadow_resolution_scale=2))
    with pytest.raises(NotImplementedError):
        shadows_cuda.refine_min_distance_cuda(depth.clone().requires_grad_(), mask, light, t_map, cfg)
    idx = torch.zeros(depth.shape, dtype=torch.int32, device=dev)
    ts = torch.from_numpy(shadows.sample_ts(cfg).astype(np.float32)).to(dev)
    with pytest.raises(ValueError):
        shadows_cuda.march_grad_cuda(depth, mask, light, idx.long(), ts, torch.ones_like(depth), cfg)
    with pytest.raises(ValueError):
        shadows_cuda.march_grad_cuda(depth, mask, light, idx, ts, torch.ones_like(depth)[:2], cfg)


# Lights for the gradient tests. The x and y of the light inside the image are
# not integers: where a light's x equals a pixel column's within the border
# solve's 1e-4, the endpoint's slope is ~1e4 and the light gradient is
# ill-conditioned (the order of float32 operations alone then moves it far
# beyond rounding); training's light points, light_distance times a unit
# vector, do not sit there.
GRAD_LIGHTS = np.asarray(
    [[1203.9, 1605.2, 3475.3], [-2407.8, 401.3, 3170.3], [5.37, -3.61, 20.0], [600.3, -300.7, 3000.0]],
    np.float32,
)


def assert_grads_close(got_d, got_l, want_d, want_l):
    """march_grad vs the plain VJP. Its atomics sum in any order, so the bars
    are relative: d_depth |d| <= 1e-4 * max |d_depth|, d_light |d| <= 1e-4 *
    max |d_light| of its image (chip_smoke.py holds the kernel to the same)."""
    assert (got_d - want_d).abs().max().item() <= 1e-4 * want_d.abs().max().item()
    scale = want_l.abs().amax(dim=1, keepdim=True)
    assert bool(((got_l - want_l).abs() <= 1e-4 * scale).all()), (got_l, want_l)


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("cull", [0, 64, 16], ids=["cull_off", "cull_row", "cull_col16"])
@pytest.mark.parametrize("veto", ["onehot", "bilinear"])
def test_march_grad_matches_plain_vjp(dev, veto, cull, gate):
    depth, mask, _ = scene(dev, seed=6)
    light = torch.from_numpy(GRAD_LIGHTS).to(dev)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=depth.shape).astype(np.float32)).to(dev)
    cfg = RenderConfig(**SMALL, shadow_mask_gather=veto, shadow_bias_gate=gate,
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    d, lp = depth.clone().requires_grad_(), light.clone().requires_grad_()
    before = dict(shadows_cuda.LAUNCHES)
    out = shadows_cuda.ray_march_min_distance_cuda(d, mask, lp, cfg)
    assert launches_since(before) == {"march": 0, "march_argmin": 1, "refine": 0, "march_grad": 0, "march_sp": 0}
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert launches_since(before) == {"march": 0, "march_argmin": 1, "refine": 0, "march_grad": 1, "march_sp": 0}
    assert_march_close(out.detach(), shadows.ray_march_min_distance_batch(depth, mask, light, cfg))
    # The plain VJP at the kernel's own winners: this holds march_grad alone.
    _, t_star = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, return_argmin_t=True)
    want_d, want_l = shadows.march_vjp(depth, mask, light, t_star, g, cfg)
    assert_grads_close(d.grad, lp.grad, want_d, want_l)


def test_render_with_a_gradient_launches_k2_and_march_grad(dev):
    depth, mask, _ = scene(dev, seed=8)
    cfg = RenderConfig(**SMALL, shadow_mask_cull=True, shadow_col_chunk=32)
    albedo = torch.rand((4, 64, 64, 3), device=dev, generator=torch.Generator(dev).manual_seed(0))
    ambient = torch.full((4,), 0.5, device=dev)
    light = torch.from_numpy(GRAD_LIGHTS).to(dev)

    def grads(device):
        d = depth.to(device).clone().requires_grad_()
        lt = light.to(device).clone().requires_grad_()
        out = render(albedo.to(device), d, torch.zeros((4, 4), device=device), mask.to(device), cfg,
                     target_light=lt, target_ambient=ambient.to(device))
        out.rendered.sum().backward()
        return d.grad.cpu(), lt.grad.cpu()

    before = dict(shadows_cuda.LAUNCHES)
    got_d, got_l = grads(dev)
    torch.cuda.synchronize()
    assert launches_since(before) == {"march": 0, "march_argmin": 1, "refine": 0, "march_grad": 1, "march_sp": 0}
    want_d, want_l = grads("cpu")
    # The renderer's eager ops round differently on the two devices, which
    # may move a knife-edge winner: agreement on >= 0.999 of the entries.
    close = (got_d - want_d).abs() <= 1e-3 * want_d.abs().max()
    assert close.float().mean().item() >= 0.999
    torch.testing.assert_close(got_l, want_l, rtol=1e-3, atol=1e-3 * want_l.abs().max().item())


def test_float32_train_step_keeps_tf32_off_through_the_backward(dev):
    """train_step turns TF32 off around its forward, backward and optimizer
    steps: with TF32 allowed globally its gradients equal those of the same
    step with TF32 off globally, up to the run-to-run spread of float32
    atomics (sum |d| / sum |g| <= 2e-4; 1.9e-5 measured on an H100). Without
    the guard (a control run) cuDNN computes them in TF32 and they part by
    at least 100 times that (0.42 measured)."""
    import contextlib

    from geomconsistentfr_torch import train as T
    from geomconsistentfr_torch.config import preset_target_lighting_train
    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData
    from geomconsistentfr_torch.models import relightnet

    cfg = preset_target_lighting_train()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **SMALL),
                              train=dataclasses.replace(cfg.train, batch_size=2))
    data = SyntheticFaceData(num_samples=2, size=64)
    batch = T.decode_batch(data.get_batch([0, 1]), dev)

    def step_grads(allow_tf32: bool):
        state = T.init_state(cfg, dev, torch.Generator().manual_seed(0))
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        try:
            T.train_step(state, batch, cfg, cfg.model.skip_gates(20))
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        return torch.cat([p.grad.flatten() for p in [*state.g.parameters(), *state.d.parameters()]])

    want = step_grads(False)
    rel = ((step_grads(True) - want).abs().sum() / want.abs().sum()).item()
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(T, "no_tf32", contextlib.nullcontext)
        m.setattr(relightnet, "no_tf32", contextlib.nullcontext)
        leaked = ((step_grads(True) - want).abs().sum() / want.abs().sum()).item()
    print(f"TF32 allowed globally, step's guard on: {rel}; guard taken out: {leaked}")
    assert rel <= 2e-4 and leaked >= 100 * max(rel, 1e-6), (rel, leaked)


# ---------------------------------------------------------------------------
# K5 and the grid step: two ranks on the one card (gloo; NCCL refuses two
# ranks on one GPU), spawned with a file:// rendezvous in tmp_path.
# ---------------------------------------------------------------------------


def load_ranks(tmp_path, tag, n=2):
    return [torch.load(tmp_path / f"{tag}_rank{r}.pt", map_location="cpu", weights_only=False) for r in range(n)]


def test_k5_on_two_ranks_is_the_full_grid_k2(dev, tmp_path):
    """K5 (RayMarchMinDistanceSP): K2 on each rank's 16 of the 32 samples, the
    MIN and first-winner combines, march_grad at the global winner. Its
    distances are bit-equal to K2 on the full grid, its winner equal on
    >= 0.9999 of pixels, each rank launches one march_sp and one march_grad,
    and each rank's gradients are the plain VJP at the winner (the bars of
    test_march_grad_matches_plain_vjp)."""
    from geomconsistentfr_torch.parallel import distributed

    import torch_parallel_child as child

    depth, mask, _ = scene(dev, seed=9)
    light = torch.from_numpy(GRAD_LIGHTS).to(dev)
    g = torch.from_numpy(np.random.default_rng(10).normal(size=depth.shape).astype(np.float32)).to(dev)
    cfg = RenderConfig(**SMALL)
    distributed.spawn(child.k5, 2, "cuda", str(tmp_path / "rdzv"),
                      args=(str(tmp_path), "k5", cfg, *(x.cpu().numpy() for x in (depth, mask, light, g))))
    ranks = load_ranks(tmp_path, "k5")
    full, t_full = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, return_argmin_t=True)
    for r in ranks:
        assert r["launches"] == {"march": 0, "march_argmin": 0, "refine": 0, "march_grad": 1, "march_sp": 1}
        assert torch.equal(r["out"], full.cpu()) and torch.equal(r["served"], full.cpu())
        assert torch.equal(r["served_min"], full.cpu()) and torch.equal(r["idx"], ranks[0]["idx"])
        t_star = r["table"][r["idx"].long()]
        assert (t_star == t_full.cpu()).float().mean().item() >= 0.9999
        want_d, want_l = shadows.march_vjp(depth, mask, light, t_star.to(dev), g, cfg)
        assert_grads_close(r["d_depth"].to(dev), r["d_light"].to(dev), want_d, want_l)


def test_grid_step_on_two_ranks_keeps_replicas_bit_identical(dev, tmp_path):
    """Two steps of the 1x2 grid step (K5 and march_grad on each rank): every
    rank's parameters, BatchNorm statistics, Adam moments and gradients are
    the same bits after each step, and the first step's losses are the
    single-process step's on the card within rtol 1e-5 (the ranks run
    cuDNN's deterministic algorithms, the process alone its defaults:
    1.05e-6 measured on an H100)."""
    from geomconsistentfr_torch import train as T
    from geomconsistentfr_torch.config import preset_target_lighting_train
    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData
    from geomconsistentfr_torch.parallel import distributed

    import torch_parallel_child as child

    cfg = preset_target_lighting_train()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **SMALL),
                              train=dataclasses.replace(cfg.train, batch_size=2))
    data = SyntheticFaceData(num_samples=4, size=64)
    batches = [data.get_batch([0, 1]), data.get_batch([2, 3])]
    state = T.init_state(cfg, dev, torch.Generator().manual_seed(0))
    start = {"g": state.g.state_dict(), "d": state.d.state_dict()}
    start = {k: {n: t.cpu() for n, t in v.items()} for k, v in start.items()}
    distributed.spawn(child.train_steps, 2, "cuda", str(tmp_path / "rdzv"),
                      args=(str(tmp_path), "grid", [(1, 2)], cfg, start, batches, (False,) * 4))
    ranks = [r["results"][(1, 2)] for r in load_ranks(tmp_path, "grid")]
    assert ranks[0]["launches"] == ranks[1]["launches"] == {
        "march": 0, "march_argmin": 0, "refine": 0, "march_grad": 2, "march_sp": 2}
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for i in range(2):
        for key, values in ranks[0]["states"][i].items():
            for name, v in values.items():
                assert torch.equal(v, ranks[1]["states"][i][key][name]), (i, key, name)
    want = [T.train_step(state, T.decode_batch(b, dev), cfg, (False,) * 4) for b in batches[:1]]
    for k, v in want[0].items():
        np.testing.assert_allclose(ranks[0]["losses"][0][k], float(v), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# The sample evaluator's edges (csrc/march.cu): integer sample coordinates,
# lights on the border and at integer points inside the image, faces on the
# first column and row (where xt or yt lies in [-1e-4, 0)), offsets at 0 and
# 1. K1, K2 and K3 are bit-equal to their plain versions there.
# ---------------------------------------------------------------------------

EDGE_LIGHTS = np.asarray(
    [[-32.0, 7.0, 25.0], [31.0, -12.0, 40.0], [5.0, 32.0, 30.0], [-9.0, -31.0, 35.0], [3.0, -4.0, 20.0],
     [1203.9, 1605.2, 3475.3]],
    np.float32,
)


def edge_scene(dev, seed=11):
    rng = np.random.default_rng(seed)
    depth = (rng.normal(size=(6, 64, 64)) * 20).astype(np.float32)
    depth[:, ::3] = np.round(depth[:, ::3])  # integer depths on every third row
    yy, xx = np.mgrid[:64, :64]
    face = ((xx - 28) / 20.0) ** 2 + ((yy - 34) / 24.0) ** 2 <= 1.0
    mask = (face & (rng.uniform(size=(6, 64, 64)) > 0.08)).astype(np.float32)
    mask[:, :, 0] = mask[:, 0, :] = 1.0
    mask[5] = 0.0  # an image with no face: every unit culled
    return [torch.from_numpy(a).to(dev) for a in (depth, mask, EDGE_LIGHTS)]


def assert_bits_equal(got, want):
    assert got.shape == want.shape
    assert torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32)), \
        (got - want).abs().max().item()


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("cull", **CULLS)
@pytest.mark.parametrize("veto", ["onehot", "bilinear"])
def test_kernels_bit_equal_on_edge_scenes(dev, veto, cull, gate):
    depth, mask, light = edge_scene(dev)
    kw = dict(shadow_mask_gather=veto, shadow_bias_gate=gate, shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    cfg = RenderConfig(**SMALL, **kw)
    ends = np.asarray([0.0, 0.005, 0.1, 0.25, 0.5, 0.995, 1.0], np.float32)  # t at 0 and 1, exact halves between
    for ts in (None, ends):
        assert_bits_equal(shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, ts),
                          shadows.ray_march_min_distance_batch(depth, mask, light, cfg, ts))
        got_d, got_t = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, ts, return_argmin_t=True)
        want_d, want_t = shadows.ray_march_min_distance_batch(depth, mask, light, cfg, ts, return_argmin_t=True)
        assert_bits_equal(got_d, want_d)
        assert torch.equal(got_t, want_t)

    dcfg = RenderConfig(**DRAFT, **kw)
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light, dcfg)
    table = shadows_cuda._ts_for(dev, m_cfg)
    _, idx = shadows.ray_march_argmin_batch(m_depth, m_mask, m_light, m_cfg, table)
    t_map = shadows.upsample_tstar_nn(table[idx.long()], dcfg)
    want = shadows.refine_min_distance_batch(depth, mask, light, t_map, dcfg)
    assert_bits_equal(shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map, dcfg), want)
    assert_bits_equal(shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, table, dcfg), want)


def test_refine_index_form_is_the_t_map_form(dev):
    """K3 around K2's winners: the kernel's own index form equals its t_map
    form bit for bit, offsets overridden too, and both count one refine
    launch."""
    depth, mask, light = scene(dev, seed=12)
    cfg = RenderConfig(**DRAFT, shadow_mask_gather="bilinear", shadow_mask_cull=True, shadow_col_chunk=64)
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light, cfg)
    table = shadows_cuda._ts_for(dev, m_cfg)
    _, idx = shadows_cuda._argmin_march(m_depth, m_mask, m_light, table, m_cfg)
    t_map = shadows.upsample_tstar_nn(table[idx.long()], cfg)
    before = dict(shadows_cuda.LAUNCHES)
    for offsets in (None, shadows.refine_offsets(cfg)[1:6]):
        assert_bits_equal(shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, table, cfg, offsets),
                          shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map, cfg, offsets))
    torch.cuda.synchronize()
    assert launches_since(before) == {"march": 0, "march_argmin": 0, "refine": 4, "march_grad": 0, "march_sp": 0}
    with pytest.raises(ValueError):
        shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx.long(), table, cfg)
    with pytest.raises(ValueError):
        shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx[:, :16].contiguous(), table, cfg)
    with pytest.raises(ValueError):
        shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, RenderConfig(**SMALL), np.float32([0.2, 1.01]))


def test_draft_render_reads_k2s_index_directly(dev, monkeypatch):
    """A draft render launches K2 once and K3 once, and makes no full-resolution
    t* map and no cull-flag pass: K3 reads K2's index, the kernels cull."""
    import geomconsistentfr_torch.render as render_module

    depth, mask, light = scene(dev, seed=13)
    cfg = RenderConfig(**DRAFT, shadow_mask_gather="bilinear", shadow_mask_cull=True, shadow_col_chunk=64)
    args = (torch.rand((4, 64, 64, 3), device=dev), depth, torch.zeros((4, 4), device=dev), mask)

    def refused(*a, **k):
        raise AssertionError("the draft path made a full-resolution t* map or cull flags")

    monkeypatch.setattr(shadows, "upsample_tstar_nn", refused)
    monkeypatch.setattr(render_module, "upsample_tstar_nn", refused)
    monkeypatch.setattr(shadows, "cull_live_blocks", refused)
    before = dict(shadows_cuda.LAUNCHES)
    out = render(*args, cfg, target_light=light)
    torch.cuda.synchronize()
    assert launches_since(before) == {"march": 0, "march_argmin": 1, "refine": 1, "march_grad": 0, "march_sp": 0}
    monkeypatch.undo()
    lp = cfg.light_distance * l2_normalize(light, dim=-1)
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, lp, cfg)
    _, t_star = shadows.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    assert_bits_equal(out.min_distance,
                      shadows.refine_min_distance_batch(depth, mask, lp, shadows.upsample_tstar_nn(t_star, cfg), cfg))
    assert_bits_equal(shadows_cuda.draft_march(depth, mask, lp, cfg), out.min_distance)

"""The CUDA march kernels (csrc/march.cu) against their plain PyTorch versions, on the card.

K1 is the march, K2 the march with the argmin, K3 the draft tier's refine,
march_grad the backward of the training march (K2 forward, march_grad
backward; the last tests drive it through render() and a train step); K5,
the sample-sharded march, is K2's key form, one MIN of the keys over the
ranks, the unpack kernel and march_grad's t-map form.
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

from chip_smoke import device_activities  # torch.profiler as the card's machine needs it
from geomconsistentfr_torch.config import RenderConfig
from geomconsistentfr_torch.ops import shadows, shadows_cuda
from geomconsistentfr_torch.ops.geometry import l2_normalize
from geomconsistentfr_torch.render import render

pytestmark = pytest.mark.cuda

SMALL = dict(img_height=64, img_width=64, num_sample_points=32, t_start=0.025, t_stop=0.185)
DRAFT = dict(SMALL, shadow_resolution_scale=2, shadow_refine_halfwidth=4, shadow_lowres_t_stride=2)
CULLS = dict(argvalues=[0, 64, 32, 16], ids=["cull_off", "cull_row", "cull_col32", "cull_col16"])
VETOES = list(shadows.VETOES)  # onehot, bilinear, hat, hat_y
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


def counts(**n):
    """Launch counts by kernel name, 0 where not given ('stage' is each march's input staging)."""
    return {k: n.get(k, 0) for k in shadows_cuda.LAUNCHES}


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("cull", **CULLS)
@pytest.mark.parametrize("veto", VETOES)
def test_kernel_matches_plain(dev, veto, cull, gate):
    depth, mask, light = scene(dev)
    cfg = RenderConfig(**SMALL, shadow_mask_gather=veto, shadow_bias_gate=gate,
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg)
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=1, march=1)
    assert_march_close(got, shadows.ray_march_min_distance_batch(depth, mask, light, cfg))


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("cull", [0, 64, 16], ids=["cull_off", "cull_row", "cull_col16"])
@pytest.mark.parametrize("veto", VETOES)
def test_argmin_kernel_matches_plain(dev, veto, cull, gate):
    depth, mask, light = scene(dev, seed=2)
    cfg = RenderConfig(**SMALL, shadow_mask_gather=veto, shadow_bias_gate=gate,
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    before = dict(shadows_cuda.LAUNCHES)
    got_d, got_t = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, return_argmin_t=True)
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=1, march_argmin=1)
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
@pytest.mark.parametrize("veto", VETOES)
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
    assert launches_since(before) == counts(stage=1, refine=1)
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
    assert launches_since(before) == counts(stage=1, march=1)
    want = shadows.ray_march_min_distance_batch(depth, mask, cfg.light_distance * l2_normalize(light, dim=-1), cfg)
    assert_march_close(out.min_distance, want)
    with pytest.raises(ValueError):
        render(*args, dataclasses.replace(cfg, use_pallas_shadows=False), target_light=light)
    assert launches_since(before) == counts(stage=1, march=1)


@pytest.mark.parametrize("halfwidth", [4, 0], ids=["refine", "upscale"])
def test_draft_render_launches_the_draft_kernels(dev, halfwidth):
    depth, mask, light = scene(dev, seed=5)
    cfg = RenderConfig(**dict(DRAFT, shadow_refine_halfwidth=halfwidth, shadow_lowres_t_stride=1),
                       shadow_mask_gather="bilinear", shadow_mask_cull=True, shadow_col_chunk=64)
    args = (torch.rand((4, 64, 64, 3), device=dev), depth, torch.zeros((4, 4), device=dev), mask)
    before = dict(shadows_cuda.LAUNCHES)
    out = render(*args, cfg, target_light=light)
    torch.cuda.synchronize()
    want_launches = (counts(stage=1, march_argmin=1, refine=1) if halfwidth
                     else counts(stage=2, march=1))  # the pooling's staging, then K1's
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


@pytest.mark.parametrize("scale", [2, 4])
def test_pool_march_inputs_is_the_plain_pooling(dev, scale):
    """The draft pooling where another march takes the pooled inputs (sample
    and grid parallelism, the refine off): one staging launch and one copy,
    scale_march_inputs' floats bit for bit, each contiguous."""
    depth, mask, light = scene(dev, seed=21)
    cfg = RenderConfig(**dict(DRAFT, shadow_resolution_scale=scale), shadow_mask_cull=True, shadow_col_chunk=64)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda.pool_march_inputs(depth, mask, light, cfg)
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=1)
    want = shadows.scale_march_inputs(depth, mask, light, cfg)
    for g, w in zip(got[:3], want[:3]):
        assert g.is_contiguous()
        assert_bits_equal(g, w)
    assert got[3] == want[3]


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
@pytest.mark.parametrize("veto", VETOES)
def test_march_grad_matches_plain_vjp(dev, veto, cull, gate):
    depth, mask, _ = scene(dev, seed=6)
    light = torch.from_numpy(GRAD_LIGHTS).to(dev)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=depth.shape).astype(np.float32)).to(dev)
    cfg = RenderConfig(**SMALL, shadow_mask_gather=veto, shadow_bias_gate=gate,
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    d, lp = depth.clone().requires_grad_(), light.clone().requires_grad_()
    before = dict(shadows_cuda.LAUNCHES)
    out = shadows_cuda.ray_march_min_distance_cuda(d, mask, lp, cfg)
    assert launches_since(before) == counts(stage=1, march_argmin=1)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=1, march_argmin=1, march_grad=1)
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
    assert launches_since(before) == counts(stage=1, march_argmin=1, march_grad=1)
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
    """K5 (RayMarchMinDistanceSP): K2's key form on each rank's 16 of the 32
    samples, one MIN of the keys, the unpack, march_grad at the global
    winner's t. Its distances are bit-equal to K2 on the full grid, its t*
    equal to the full grid's winner on >= 0.9999 of pixels, each rank
    launches one march_sp, one unpack_key and one march_grad and issues
    exactly one collective (forward and backward, counted by a wrapper on
    torch.distributed's collectives in the rank), and each rank's gradients
    are the plain VJP at the winner (the bars of
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
        assert r["launches"] == counts(stage=1, march_grad=1, march_sp=1, unpack_key=1)
        assert r["collectives"] == 1 and r["collective_bytes"] == 8 * full.numel()
        assert torch.equal(r["out"], full.cpu()) and torch.equal(r["served"], full.cpu())
        assert torch.equal(r["served_min"], full.cpu()) and torch.equal(r["t_star"], ranks[0]["t_star"])
        t_star = r["t_star"]
        assert torch.equal(r["served_t"], t_star)
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
    assert ranks[0]["launches"] == ranks[1]["launches"] == counts(stage=2, march_grad=2, march_sp=2, unpack_key=2)
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
@pytest.mark.parametrize("veto", VETOES)
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
    table, _ = shadows_cuda._ts_for(dev, m_cfg)
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
    table, clamp = shadows_cuda._ts_for(dev, m_cfg)
    _, idx, _ = shadows_cuda._argmin(m_depth, m_mask, m_light, table, m_cfg, clamp=clamp)
    t_map = shadows.upsample_tstar_nn(table[idx.long()], cfg)
    before = dict(shadows_cuda.LAUNCHES)
    for offsets in (None, shadows.refine_offsets(cfg)[1:6]):
        assert_bits_equal(shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, table, cfg, offsets),
                          shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map, cfg, offsets))
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=4, refine=4)
    with pytest.raises(ValueError):
        shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx.long(), table, cfg)
    with pytest.raises(ValueError):
        shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx[:, :16].contiguous(), table, cfg)
    # A table past 1: the clamped taps, bit-equal to the plain march (tests below hold them more widely).
    past = np.float32([0.2, 1.01])
    assert_bits_equal(shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, RenderConfig(**SMALL), past),
                      shadows.ray_march_min_distance_batch(depth, mask, light, RenderConfig(**SMALL), past))


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
    assert launches_since(before) == counts(stage=1, march_argmin=1, refine=1)
    monkeypatch.undo()
    lp = cfg.light_distance * l2_normalize(light, dim=-1)
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, lp, cfg)
    _, t_star = shadows.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    assert_bits_equal(out.min_distance,
                      shadows.refine_min_distance_batch(depth, mask, lp, shadows.upsample_tstar_nn(t_star, cfg), cfg))
    assert_bits_equal(shadows_cuda.draft_march(depth, mask, lp, cfg), out.min_distance)


# ---------------------------------------------------------------------------
# The staging pass (stage_kernel), K2 on its output, K3 reading its flags, and
# march_grad on the forward's staged quad.
# ---------------------------------------------------------------------------


STAGINGS = dict(argvalues=[(1, 0), (1, 16), (1, 64), (2, 0), (2, 16), (2, 64), (4, 32)],
                ids=["s1", "s1_col16", "s1_row", "s2", "s2_col16", "s2_row", "s4_col32"])


@pytest.mark.parametrize("scale, cull", **STAGINGS)
def test_staging_is_bit_equal_to_its_plain_version(dev, scale, cull):
    """stage_kernel against shadows.stage_inputs: the padded quads (pooled at
    s > 1), both resolutions' cull flags and the scaled light, bit for bit,
    on the edge scenes (an image with no face, faces on the first row and
    column, integer depths) and on all-on, single-pixel and half-on blocks."""
    depth, mask, light = edge_scene(dev)
    mask[0] = 1.0                        # every block on face
    mask[1] = 0.0
    mask[1, 13, 29] = 3.0                # one face pixel, nonzero but not 1
    mask[2, ::2] = 0.0                   # half of each 2x2 block: the majority's edge
    cfg = RenderConfig(**dict(DRAFT, shadow_resolution_scale=scale, shadow_lowres_t_stride=min(scale, 2)),
                       shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda._stage(depth, mask, light, cfg, draft=scale > 1, flags=True)
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=1)
    want = shadows.stage_inputs(depth, mask, light, cfg)
    for field in shadows.Staged._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, field
            assert torch.equal(g.contiguous().view(torch.uint8), w.contiguous().view(torch.uint8)), field
    if scale > 1:
        m_depth, m_mask, m_light, _ = shadows.scale_march_inputs(depth, mask, light, cfg)
        assert torch.equal(got.quad, shadows.pad_quad(m_depth, m_mask)) and torch.equal(got.light, m_light)


@pytest.mark.parametrize("cull", [False, True], ids=["cull_off", "cull_on"])
@pytest.mark.parametrize("veto", VETOES)
@pytest.mark.parametrize("shape", ["draft", "training"])
def test_k2_on_the_staged_input_is_bit_equal(dev, shape, veto, cull):
    """K2 as the main paths run it: at draft (64 images of 256^2 pooled 4x4,
    80 samples, on the staging pass's pooled quad, flags and light) and at
    training (3 of 256^2, 160 samples, on its own staging). Distances bit for
    bit and the index on every pixel, against the plain argmin march of the
    plain pooled inputs."""
    from geomconsistentfr_torch.config import apply_precision_tier, preset_single_image, preset_target_lighting_train

    b = 64 if shape == "draft" else 3
    rng = np.random.default_rng(14)
    yy, xx = np.mgrid[:256, :256]
    depth = (rng.normal(size=(b, 256, 256)) * 20 + 40 * np.cos(xx / 40.0) * np.sin(yy / 30.0)).astype(np.float32)
    face = ((xx - 120) / 80.0) ** 2 + ((yy - 136) / 100.0) ** 2 <= 1.0
    mask = (face & (rng.uniform(size=(b, 256, 256)) > 0.05)).astype(np.float32)
    dirs = rng.normal(size=(b, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5
    light = (4013.0 * dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    depth, mask, light = (torch.from_numpy(a).to(dev) for a in (depth, mask, light))
    base = (apply_precision_tier(preset_single_image(), "draft") if shape == "draft"
            else preset_target_lighting_train()).render
    cfg = dataclasses.replace(base, shadow_mask_gather=veto, shadow_mask_cull=cull, shadow_step_pack=1)
    if shape == "draft":
        m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light, cfg)
        ts, clamp = shadows_cuda._ts_for(dev, m_cfg)
        staged = shadows_cuda._stage(depth, mask, light, cfg, draft=True, flags=True)
        idx = torch.empty(m_depth.shape, dtype=torch.int32, device=dev)
        got = shadows_cuda._launch("march_argmin", staged, None, staged.light, ts, m_cfg, idx=idx, clamp=clamp)
    else:
        m_depth, m_mask, m_light, m_cfg = depth, mask, light, cfg
        ts, clamp = shadows_cuda._ts_for(dev, cfg)
        got, idx, _ = shadows_cuda._launch_argmin(depth, mask, light, ts, cfg, clamp=clamp)
    want, want_idx = shadows.ray_march_argmin_batch(m_depth, m_mask, m_light, m_cfg, ts)
    assert_bits_equal(got, want)
    assert torch.equal(idx, want_idx)


@pytest.mark.parametrize("cull", [16, 32, 64], ids=["cull_col16", "cull_col32", "cull_row"])
@pytest.mark.parametrize("veto", VETOES)
def test_refine_reading_flags_equals_refine_scanning_the_mask(dev, veto, cull):
    """K3 on the staging pass's full-resolution quad and flags (the draft
    path) equals K3 that scans the mask itself (refine_around_argmin_cuda),
    bit for bit, on the edge scenes with their all-culled image."""
    depth, mask, light = edge_scene(dev, seed=15)
    cfg = RenderConfig(**DRAFT, shadow_mask_gather=veto, shadow_mask_cull=True, shadow_col_chunk=cull)
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light, cfg)
    table, _ = shadows_cuda._ts_for(dev, m_cfg)
    _, idx = shadows.ray_march_argmin_batch(m_depth, m_mask, m_light, m_cfg, table)
    staged = shadows_cuda._stage(depth, mask, light, cfg, draft=True, flags=True)
    full = shadows.Staged(staged.full, staged.full_flags)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda._launch("refine", full, None, light, shadows_cuda._refine_offsets(dev, cfg), cfg,
                               centre=(idx, table))
    assert launches_since(before) == counts(refine=1)
    assert_bits_equal(got, shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, table, cfg))
    assert bool((got[5] == 1e6).all())


def test_draft_march_runs_three_kernels(dev):
    """One draft march is three device launches, the staging pass, K2 and
    K3, and nothing else (no pooling ops, no scaled light, no t* map), bit-
    equal to the plain draft path; a draft render launches the same three."""
    depth, mask, light = scene(dev, seed=16)
    cfg = RenderConfig(**DRAFT, shadow_mask_gather="bilinear", shadow_mask_cull=True, shadow_col_chunk=64)
    names = device_activities(lambda: shadows_cuda.draft_march(depth, mask, light, cfg), 3)
    assert len(names) == 3 * 5, names
    assert [any(k in n for n in names) for k in ("stage_kernel", "march_kernel<1", "march_kernel<2")] == [True] * 3
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light, cfg)
    _, t_star = shadows.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    assert_bits_equal(shadows_cuda.draft_march(depth, mask, light, cfg),
                      shadows.refine_min_distance_batch(depth, mask, light, shadows.upsample_tstar_nn(t_star, cfg), cfg))
    from geomconsistentfr_torch.render import shadow_min_distance

    march = device_activities(lambda: shadow_min_distance(depth, mask, light, cfg), 3)
    assert len(march) == 3 * 5, march


@pytest.mark.parametrize("cull", [0, 64, 16], ids=["cull_off", "cull_row", "cull_col16"])
@pytest.mark.parametrize("veto", VETOES)
def test_march_grad_on_edge_scenes(dev, veto, cull):
    """march_grad on the forward's quad at the plain VJP's bars, on the edge
    scenes: lights on the image border and at integer points inside it (the
    samples' integer coordinates, where the ceil tap is the floor tap),
    faces on the first row and column, an image with no face (culled, or
    vetoed everywhere), and an image whose cotangent is zero. The wrapper
    runs one zero fill and the kernel: no cull-flag pass."""
    depth, mask, light = edge_scene(dev, seed=17)
    g = torch.from_numpy(np.random.default_rng(18).normal(size=depth.shape).astype(np.float32)).to(dev)
    g[3] = 0.0
    cfg = RenderConfig(**SMALL, shadow_mask_gather=veto, shadow_mask_cull=cull > 0, shadow_col_chunk=cull)
    d, lp = depth.clone().requires_grad_(), light.clone().requires_grad_()
    out = shadows_cuda.ray_march_min_distance_cuda(d, mask, lp, cfg)
    (out * g).sum().backward()
    _, t_star = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, return_argmin_t=True)
    want_d, want_l = shadows.march_vjp(depth, mask, light, t_star, g, cfg)
    assert_grads_close(d.grad, lp.grad, want_d, want_l)
    for i in (3, 5):
        assert not d.grad[i].any() and not lp.grad[i].any()
    ts, clamp = shadows_cuda._ts_for(dev, cfg)
    _, idx, staged = shadows_cuda._launch_argmin(depth, mask, light, ts, cfg, clamp=clamp)
    names = device_activities(lambda: shadows_cuda.march_grad_cuda(depth, mask, light, idx, ts, g, cfg, staged), 2)
    assert len(names) == 2 * 5 and sum("march_grad_kernel" in n for n in names) == 5, names
    with pytest.raises(ValueError):
        shadows_cuda.march_grad_cuda(depth, mask, light, idx, ts, g, cfg)


def light_grad_terms(depth, mask, light, t_star, g, cfg):
    """(B, 3) float64: the sum over pixels of |each pixel's term of d_light|
    (the plain VJP with the cotangent kept at one pixel at a time). A float32
    sum of those terms, in any order and with any rounding of the terms,
    is within a few 1e-7 of this of its exact value."""
    b, h, w = depth.shape
    out = torch.zeros((b, 3), dtype=torch.float64, device=depth.device)
    for i in range(b):
        for start in range(0, h * w, 1024):
            pix = torch.arange(start, min(start + 1024, h * w), device=depth.device)
            k = pix.numel()
            cot = torch.zeros((k, h * w), device=depth.device)
            cot[torch.arange(k, device=depth.device), pix] = g[i].reshape(-1)[pix]
            rep = [x[i:i + 1].expand(k, *x.shape[1:]).contiguous() for x in (depth, mask, light, t_star)]
            _, dl = shadows.march_vjp(*rep, cot.view(k, h, w), cfg)
            out[i] += dl.abs().double().sum(dim=0)
    return out


def test_k5_backward_in_one_process(dev):
    """K5 with no group (one shard, the whole table): its forward stages and
    launches K2's key form once (as 'march_sp') and the unpack once, its
    backward march_grad once on the forward's quad, at the unpacked t*. Its gradients are K4's (the same kernels: only the
    atomics' order differs) at the march_grad bars, and the plain VJP's:
    d_depth at its bar, d_light within 1e-5 of the sum of its pixels' |terms|.
    On this scene image 1's light gradient is ill-conditioned: its y term
    sums to -0.197 from terms whose magnitudes sum to 35.9, and the kernel's
    chain rule and autograd's round the terms differently, so it parts from
    the plain VJP by 1.1e-4 of the image's max (in the kernel before the
    redesign as in this one), over the 1e-4 bar relative to that max."""
    depth, mask, _ = scene(dev, seed=19)
    light = torch.from_numpy(GRAD_LIGHTS).to(dev)
    g = torch.from_numpy(np.random.default_rng(20).normal(size=depth.shape).astype(np.float32)).to(dev)
    cfg = RenderConfig(**SMALL, shadow_mask_cull=True, shadow_col_chunk=32)
    ts = shadows.sample_ts(cfg).astype(np.float32)
    d, lp = depth.clone().requires_grad_(), light.clone().requires_grad_()
    before = dict(shadows_cuda.LAUNCHES)
    out = shadows_cuda.RayMarchMinDistanceSP.apply(d, mask, lp, cfg, ts, None)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=1, march_sp=1, march_grad=1, unpack_key=1)
    want_out, t_star = shadows.ray_march_min_distance_batch(depth, mask, light, cfg, return_argmin_t=True)
    assert_bits_equal(out.detach(), want_out)
    d4, lp4 = depth.clone().requires_grad_(), light.clone().requires_grad_()
    (shadows_cuda.ray_march_min_distance_cuda(d4, mask, lp4, cfg) * g).sum().backward()
    assert_grads_close(d.grad, lp.grad, d4.grad, lp4.grad)
    want_d, want_l = shadows.march_vjp(depth, mask, light, t_star, g, cfg)
    assert (d.grad - want_d).abs().max().item() <= 1e-4 * want_d.abs().max().item()
    terms = light_grad_terms(depth, mask, light, t_star, g, cfg)
    assert bool(((lp.grad - want_l).abs().double() <= 1e-5 * terms).all()), (lp.grad - want_l, terms)


# ---------------------------------------------------------------------------
# K5's key path: K2's key form, the unpack, march_grad's t-map form.
# ---------------------------------------------------------------------------

# 160 samples: K2 splits a pixel over two lanes (kSplitFrom = 128); t up to 0.82.
KEY_GRIDS = {32: dict(t_stop=0.185), 160: dict(t_stop=0.8245)}


@pytest.mark.parametrize("bias", [5.0, -20.0], ids=["bias_pos", "bias_neg"])
@pytest.mark.parametrize("cull", [0, 16], ids=["cull_off", "cull_col16"])
@pytest.mark.parametrize("samples", [32, 160], ids=["one_lane", "two_lanes"])
def test_k2_key_form_is_the_packed_index_form(dev, samples, cull, bias):
    """K2's key epilogue writes pack_march_key(out, ts[idx]) of its index form, bit for bit, at one
    and two lanes a pixel, with the gate's bias on (negative distances where it is negative), on
    the edge scenes with their all-culled image (the sentinel and ts[0]); the plain argmin march
    packs the same words."""
    depth, mask, light = edge_scene(dev, seed=23)
    cfg = RenderConfig(**dict(SMALL, num_sample_points=samples, **KEY_GRIDS[samples]),
                       shadow_bias_gate="inside_image", shadow_bias=bias, shadow_mask_cull=cull > 0,
                       shadow_col_chunk=cull)
    ts, clamp = shadows_cuda._ts_for(dev, cfg)
    assert ts.numel() == samples and not clamp
    out, idx, _ = shadows_cuda._launch_argmin(depth, mask, light, ts, cfg, clamp=clamp)
    before = dict(shadows_cuda.LAUNCHES)
    key, staged = shadows_cuda._march_key(depth, mask, light, ts, cfg, clamp=clamp)
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=1, march_argmin=1)
    assert key.dtype == torch.int64 and key.shape == out.shape and staged.quad.shape == (6, 65, 65, 2)
    assert torch.equal(key, shadows.pack_march_key(out, ts[idx.long()]))
    want_d, want_idx = shadows.ray_march_argmin_batch(depth, mask, light, cfg, ts)
    assert torch.equal(key, shadows.pack_march_key(want_d, ts[want_idx.long()]))
    # Image 5 has no face and a light outside the gate: the sentinel, and the table's first offset.
    assert bool((out[5] == 1e6).all()) and bool((shadows.unpack_march_key(key)[1][5] == ts[0]).all())
    if bias < 0:
        assert bool((out < 0).any())


def test_unpack_kernel_is_its_plain_version(dev):
    """unpack_key_kernel equals shadows.unpack_march_key bit for bit, on K2's keys (their distances
    bit-equal to K2's index form) and on random 64-bit words, at a size no block divides."""
    depth, mask, light = edge_scene(dev, seed=24)
    cfg = RenderConfig(**SMALL, shadow_bias_gate="inside_image", shadow_bias=-20.0, shadow_mask_cull=True,
                       shadow_col_chunk=32)
    ts, clamp = shadows_cuda._ts_for(dev, cfg)
    out, idx, _ = shadows_cuda._launch_argmin(depth, mask, light, ts, cfg, clamp=clamp)
    key, _ = shadows_cuda._march_key(depth, mask, light, ts, cfg, clamp=clamp)
    words = torch.from_numpy(np.random.default_rng(25).integers(-2 ** 63, 2 ** 63 - 1, size=5001,
                                                                 dtype=np.int64)).to(dev)
    before = dict(shadows_cuda.LAUNCHES)
    for k in (key, words, key.view(-1)[:1001]):
        got_d, got_t = shadows_cuda.unpack_march_key(k)
        want_d, want_t = shadows.unpack_march_key(k)
        assert_bits_equal(got_d, want_d)
        assert_bits_equal(got_t, want_t)
    torch.cuda.synchronize()
    assert launches_since(before) == counts(unpack_key=3)
    got_d, got_t = shadows_cuda.unpack_march_key(key)
    assert_bits_equal(got_d, out)
    assert torch.equal(got_t, ts[idx.long()])
    with pytest.raises(ValueError):
        shadows_cuda.unpack_march_key(key.to(torch.int32))


def test_march_grad_t_map_form_is_the_index_form(dev):
    """march_grad reading t* from a per-pixel map (K5's backward) against its index form. Each
    image of a batch of 64 (16 on-face pixels of each of 4 scenes) has a cotangent on one pixel,
    so one thread makes its gradients and the atomics add in one order: the two forms are bit-equal.
    Under a dense cotangent, where the atomics add in any order, they agree at the march_grad bars."""
    depth, mask, _ = scene(dev, seed=26)
    light = torch.from_numpy(GRAD_LIGHTS).to(dev)
    cfg = RenderConfig(**SMALL, shadow_mask_cull=True, shadow_col_chunk=32)
    ts, clamp = shadows_cuda._ts_for(dev, cfg)
    rng = np.random.default_rng(27)
    src, pix = [], []
    for i in range(4):
        on = np.flatnonzero(mask[i].cpu().numpy().reshape(-1))
        src += [i] * 16
        pix += list(rng.choice(on, 16, replace=False))
    src = torch.tensor(src, device=dev)
    d, m, lp = (x.index_select(0, src).contiguous() for x in (depth, mask, light))
    _, idx, staged = shadows_cuda._launch_argmin(d, m, lp, ts, cfg, clamp=clamp)
    g = torch.zeros_like(d)
    g.view(64, -1)[torch.arange(64, device=dev), torch.tensor(pix, device=dev)] = torch.from_numpy(
        rng.normal(size=64).astype(np.float32)).to(dev)
    before = dict(shadows_cuda.LAUNCHES)
    by_idx = shadows_cuda.march_grad_cuda(d, m, lp, idx, ts, g, cfg, staged)
    by_t = shadows_cuda.march_grad_at_cuda(d, m, lp, ts[idx.long()], g, cfg, staged)
    torch.cuda.synchronize()
    assert launches_since(before) == counts(march_grad=2)
    assert by_idx[0].abs().max().item() > 0 and by_idx[1].abs().max().item() > 0
    assert_bits_equal(by_t[0], by_idx[0])
    assert_bits_equal(by_t[1], by_idx[1])
    dense = torch.from_numpy(rng.normal(size=tuple(d.shape)).astype(np.float32)).to(dev)
    assert_grads_close(*shadows_cuda.march_grad_at_cuda(d, m, lp, ts[idx.long()], dense, cfg, staged),
                       *shadows_cuda.march_grad_cuda(d, m, lp, idx, ts, dense, cfg, staged))
    # t* past 1 (the clamped taps): the plain VJP at the same t, d_light within 1e-5 of the sum of
    # its pixels' |terms| (a sample outside the image sums terms that cancel), on 8 of the images.
    past = (ts[idx.long()] + 0.5)[:8].contiguous()
    d8, m8, lp8, dense8 = (x[:8].contiguous() for x in (d, m, lp, dense))
    staged8 = shadows_cuda._stage(d8, m8, lp8, cfg, flags=True)
    got_d, got_l = shadows_cuda.march_grad_at_cuda(d8, m8, lp8, past, dense8, cfg, staged8)
    want_d, want_l = shadows.march_vjp(d8, m8, lp8, past, dense8, cfg)
    assert (got_d - want_d).abs().max().item() <= 1e-4 * want_d.abs().max().item()
    terms = light_grad_terms(d8, m8, lp8, past, dense8, cfg)
    assert bool(((got_l - want_l).abs().double() <= 1e-5 * terms).all()), (got_l - want_l, terms)


def test_march_over_lights_on_the_card(dev):
    """shadows.ray_march_min_distance_lights on CUDA tensors: one staging and one K1 launch over the
    image expanded across the lights, bit-equal to the plain march of the repeated image."""
    depth, mask, light = edge_scene(dev, seed=28)
    cfg = RenderConfig(**SMALL, shadow_mask_cull=True, shadow_col_chunk=16)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows.ray_march_min_distance_lights(depth[0], mask[0], light, cfg)
    torch.cuda.synchronize()
    assert launches_since(before) == counts(stage=1, march=1)
    n = light.shape[0]
    assert_bits_equal(got, shadows.ray_march_min_distance_batch(depth[:1].expand(n, 64, 64).contiguous(),
                                                                 mask[:1].expand(n, 64, 64).contiguous(), light, cfg))


# ---------------------------------------------------------------------------
# The sizes and t tables RenderConfig admits beyond the presets': rows that
# no 8-row group fills, columns that no 32-column block fills, cull chunks
# that are no power of two, W above 2048, tables past [0, 1].
# ---------------------------------------------------------------------------

ADMITTED = {"60x60_row": (60, 60, 0), "240x240_col48": (240, 240, 48), "8x4096_row": (8, 4096, 0),
            "40x72_col24": (40, 72, 24), "36x48_col16": (36, 48, 16)}


def sized_scene(dev, h, w, b=3, seed=30):
    """Cosine terrain with noise, an oval face with holes (and one image with none), lights far,
    inside the image and on its border."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    depth = (rng.normal(size=(b, h, w)) * 5 + 30 * np.cos(xx / 9.0) * np.sin(yy / 7.0)).astype(np.float32)
    face = ((xx - 0.47 * w) / (0.35 * w)) ** 2 + ((yy - 0.53 * h) / (0.45 * h)) ** 2 <= 1.0
    mask = (face & (rng.uniform(size=(b, h, w)) > 0.05)).astype(np.float32)
    mask[b - 1] = 0.0
    light = np.asarray([[1203.9, 1605.2, 3475.3], [0.37 * w / 4, -0.29 * h / 4, 20.0],
                        [-w / 2.0, 0.6 * h / 4, 30.0]], np.float32)[:b]
    return [torch.from_numpy(a).to(dev) for a in (depth, mask, light)]


def sized_cfg(h, w, chunk, veto, **kw):
    return RenderConfig(img_height=h, img_width=w, num_sample_points=32, t_start=0.025, t_stop=0.185,
                        shadow_mask_gather=veto, shadow_mask_cull=True, shadow_col_chunk=chunk,
                        shadow_bias_gate="inside_image", shadow_refine_halfwidth=4, **kw)


@pytest.mark.parametrize("veto", VETOES)
@pytest.mark.parametrize("shape", list(ADMITTED))
def test_kernels_at_the_sizes_the_config_admits(dev, shape, veto):
    """The staging, K1, K2 (distances and winners), K3 around a t_map and
    around K2's index, bit-equal to their plain versions; march_grad at the
    plain VJP's d_depth bar, its d_light within 1e-5 of the sum of its
    pixels' |terms| (test_k5_backward_in_one_process says why). 8x4096
    takes the clamped taps (W > 2048)."""
    h, w, chunk = ADMITTED[shape]
    depth, mask, light = sized_scene(dev, h, w)
    cfg = sized_cfg(h, w, chunk, veto)
    staged = shadows_cuda._stage(depth, mask, light, cfg, flags=True)
    want = shadows.stage_inputs(depth, mask, light, cfg)
    assert staged.flags.shape == (3, -(-h // 8), w // shadows.effective_col_chunk(cfg))
    assert torch.equal(staged.quad, want.quad) and torch.equal(staged.flags, want.flags)
    assert_bits_equal(shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg),
                      shadows.ray_march_min_distance_batch(depth, mask, light, cfg))
    got_d, got_t = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, return_argmin_t=True)
    want_d, want_t = shadows.ray_march_min_distance_batch(depth, mask, light, cfg, return_argmin_t=True)
    assert_bits_equal(got_d, want_d)
    assert torch.equal(got_t, want_t)
    assert_bits_equal(shadows_cuda.refine_min_distance_cuda(depth, mask, light, want_t, cfg),
                      shadows.refine_min_distance_batch(depth, mask, light, want_t, cfg))
    ts, _ = shadows_cuda._ts_for(dev, cfg)
    _, idx = shadows.ray_march_argmin_batch(depth, mask, light, cfg, ts)
    assert_bits_equal(shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, ts,
                                                             dataclasses.replace(cfg, shadow_resolution_scale=1)),
                      shadows.refine_min_distance_batch(depth, mask, light, ts[idx.long()], cfg))
    g = torch.from_numpy(np.random.default_rng(31).normal(size=tuple(depth.shape)).astype(np.float32)).to(dev)
    d, lp = depth.clone().requires_grad_(), light.clone().requires_grad_()
    (shadows_cuda.ray_march_min_distance_cuda(d, mask, lp, cfg) * g).sum().backward()
    want_dd, want_dl = shadows.march_vjp(depth, mask, light, want_t, g, cfg)
    assert (d.grad - want_dd).abs().max().item() <= 1e-4 * want_dd.abs().max().item()
    terms = light_grad_terms(depth, mask, light, want_t, g, cfg)
    assert bool(((lp.grad - want_dl).abs().double() <= 1e-5 * terms).all()), (lp.grad - want_dl, terms)


@pytest.mark.parametrize("veto", VETOES)
@pytest.mark.parametrize("size, chunk", [(240, 0), (240, 80), (120, 0)], ids=["240_row", "240_col80", "120_row"])
def test_draft_march_at_the_sizes_the_config_admits(dev, size, chunk, veto):
    """The draft march (staging, K2, K3) where H/4 is no multiple of 8
    (240: a 60x60 low-resolution march, under the row cull there, and at
    full resolution the row cull or 80-column units; 120: 30x30), bit-equal
    to the plain draft path, its staging to the plain staging."""
    from geomconsistentfr_torch.config import apply_precision_tier, preset_single_image

    depth, mask, light = sized_scene(dev, size, size, seed=32)
    cfg = dataclasses.replace(apply_precision_tier(preset_single_image(), "draft").render, img_height=size,
                              img_width=size, shadow_col_chunk=chunk, shadow_mask_gather=veto, shadow_step_pack=1)
    got = shadows_cuda._stage(depth, mask, light, cfg, draft=True, flags=True)
    want = shadows.stage_inputs(depth, mask, light, cfg)
    for field in shadows.Staged._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None and w is None) or torch.equal(g, w), field
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light, cfg)
    _, t_star = shadows.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    assert_bits_equal(shadows_cuda.draft_march(depth, mask, light, cfg),
                      shadows.refine_min_distance_batch(depth, mask, light, shadows.upsample_tstar_nn(t_star, cfg), cfg))


@pytest.mark.parametrize("veto", VETOES)
def test_tables_outside_the_unit_interval(dev, veto):
    """A t grid to 1.02 (200 samples: K2 on two lanes), a given table from
    -0.05, and the refine's t range past 1: the clamped taps, bit-equal to
    the plain versions; march_grad at the plain VJP's bars through autograd;
    K2's key form on the negative table packs the plain keys, and their MIN
    over two slices unpacks to the full table's winners."""
    depth, mask, light = sized_scene(dev, 64, 64, seed=33)
    cfg = RenderConfig(img_height=64, img_width=64, num_sample_points=200, t_stop=1.025, shadow_mask_gather=veto,
                       shadow_mask_cull=True, shadow_col_chunk=16, shadow_resolution_scale=1,
                       shadow_refine_halfwidth=4)
    ts, clamp = shadows_cuda._ts_for(dev, cfg)
    assert float(ts.max()) > 1.0 and clamp
    below = np.linspace(-0.05, 0.3, 24).astype(np.float32)
    for table in (None, below):
        assert_bits_equal(shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, table),
                          shadows.ray_march_min_distance_batch(depth, mask, light, cfg, table))
        got_d, got_t = shadows_cuda.ray_march_min_distance_cuda(depth, mask, light, cfg, table, return_argmin_t=True)
        want_d, want_t = shadows.ray_march_min_distance_batch(depth, mask, light, cfg, table, return_argmin_t=True)
        assert_bits_equal(got_d, want_d)
        assert torch.equal(got_t, want_t)
    t_map = torch.full_like(depth, 1.01)
    assert_bits_equal(shadows_cuda.refine_min_distance_cuda(depth, mask, light, t_map, cfg),
                      shadows.refine_min_distance_batch(depth, mask, light, t_map, cfg))
    g = torch.from_numpy(np.random.default_rng(34).normal(size=tuple(depth.shape)).astype(np.float32)).to(dev)
    d, lp = depth.clone().requires_grad_(), light.clone().requires_grad_()
    (shadows_cuda.ray_march_min_distance_cuda(d, mask, lp, cfg) * g).sum().backward()
    _, t_star = shadows.ray_march_min_distance_batch(depth, mask, light, cfg, return_argmin_t=True)
    assert_grads_close(d.grad, lp.grad, *shadows.march_vjp(depth, mask, light, t_star, g, cfg))
    table = torch.from_numpy(below).to(dev)
    keys = [shadows_cuda._march_key(depth, mask, light, half, cfg, clamp=True)[0] for half in table.view(2, -1)]
    for key, half in zip(keys, table.view(2, -1)):
        d_, i_ = shadows.ray_march_argmin_batch(depth, mask, light, cfg, half)
        assert torch.equal(key, shadows.pack_march_key(d_, half[i_.long()]))
    got_d, got_t = shadows_cuda.unpack_march_key(torch.minimum(*keys))
    full_d, full_t = shadows.ray_march_min_distance_batch(depth, mask, light, cfg, below, return_argmin_t=True)
    assert_bits_equal(got_d, full_d)
    assert (got_t == full_t).float().mean().item() >= 0.9999


@pytest.mark.parametrize("tier", ["strict", "fast"])
def test_relighter_gives_the_same_bytes_from_call_to_call(dev, tier):
    """Relighter runs its CNN under cuDNN's deterministic algorithms. Under
    cuDNN's defaults the float32 CNN added in an order that changed from call
    to call on an H100, and a few bytes of a batch-1 visual pack moved by one
    level. Full width (RelightNet's channels at 256x256, where that showed),
    seeded random weights; a batch of 8 runs between the calls, since cuDNN
    picks its algorithm per shape."""
    from pathlib import Path

    from geomconsistentfr_torch.config import apply_precision_tier, preset_single_image
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.relightnet import RelightNet

    fx = np.load(Path(__file__).parent / "golden" / "ref_transfer_00104.npz")
    cfg = apply_precision_tier(preset_single_image(), tier)
    rl = Relighter(cfg, RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict())
    row = (fx["image"][None], fx["mask"][None], np.array([[0.6893, 0.3991, 0.6047]], np.float32),
           np.array([0.5], np.float32))
    first = rl.forward_visuals(*row).cpu().numpy()
    for _ in range(3):
        rl.forward_visuals(*(np.repeat(a, 8, 0) for a in row))
        assert np.array_equal(rl.forward_visuals(*row).cpu().numpy(), first)


@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_estimate_at_batch_64_is_the_full_forwards_light_and_pack(dev, variant):
    """estimate_lighting runs the encoder and the lighting head alone: at batch 64,
    256x256, tier high, its light and ambient are the bits of `estimated_light` on the
    full forward's lighting, and a transfer call's packed visuals under them are the
    bytes of the same call under the full forward's estimate. Seeded random weights."""
    from pathlib import Path

    from geomconsistentfr_torch.config import apply_precision_tier, preset_lighting_transfer, preset_single_image
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.layers import deterministic_convs
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.render import estimated_light

    fx = np.load(Path(__file__).parent / "golden" / "ref_transfer_00104.npz")
    rng = np.random.default_rng(5)

    def jittered(image):
        return np.clip(image[None] + rng.uniform(-0.03, 0.03, (64, *image.shape)), 0.0, 1.0).astype(np.float32)

    refs, inputs = jittered(fx["image"][:, ::-1]), jittered(fx["image"])
    masks = np.repeat(fx["mask"][None], 64, 0)
    preset = preset_single_image if variant == "target" else preset_lighting_transfer
    cfg = apply_precision_tier(preset(), "high")
    rl = Relighter(cfg, RelightNet(cfg.model, generator=torch.Generator().manual_seed(1)).state_dict())
    unit, ambient = rl.estimate_lighting(refs)
    with torch.no_grad(), deterministic_convs():
        lighting = rl.model(rl._as_input(refs), rl.use_skips).lighting
    want_unit, want_ambient = estimated_light(lighting, cfg.render)
    assert unit.shape == (64, 3) and torch.equal(unit, want_unit) and torch.equal(ambient, want_ambient)
    got = rl.forward_visuals(inputs, masks, target_light=unit, target_ambient=ambient)
    want = rl.forward_visuals(inputs, masks, target_light=want_unit, target_ambient=want_ambient)
    assert got.dtype == torch.uint8 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# Training from the CLI and the secondary models on the card
# ---------------------------------------------------------------------------


def small_train_cfg(**train):
    from geomconsistentfr_torch.config import preset_target_lighting_train

    cfg = preset_target_lighting_train()
    return dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, img_height=32, img_width=32, num_sample_points=16, t_stop=0.105),
        train=dataclasses.replace(cfg.train, **{"batch_size": 2, "batches_per_epoch": 3, **train}))


def u8_cache(root, n=10, size=32):
    import json

    from geomconsistentfr_torch.data.celebahq import FIELDS

    rng = np.random.default_rng(4)
    for name, (dt, shape) in FIELDS.items():
        shape = tuple(size if d == 256 else d for d in shape)
        np.save(root / f"{name}.npy",
                (rng.integers(0, 256, (n, *shape)) if dt == np.uint8 else rng.normal(size=(n, *shape))).astype(dt))
    (root / "meta.json").write_text(json.dumps({"num_samples": n}))
    return str(root)


def test_resident_batches_are_the_streamed_batches_on_the_card(dev, tmp_path):
    """The uint8 cache on the card, gathered and divided there: the streamed batches' bits."""
    from geomconsistentfr_torch.data.celebahq import CelebAHQRelightingData
    from geomconsistentfr_torch.train import DeviceResidentBatches, Trainer

    data = CelebAHQRelightingData(u8_cache(tmp_path))
    batches = {}
    for residency in ("device", "stream"):
        trainer = Trainer(small_train_cfg(data_residency=residency), data, workdir=str(tmp_path / residency))
        assert isinstance(trainer._resident(), DeviceResidentBatches) == (residency == "device")
        batches[residency] = list(trainer._batches(np.random.default_rng([0, 1]), 0))
    for got, want in zip(batches["device"], batches["stream"]):
        for k in want:
            assert got[k].device.type == "cuda" and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_on_the_card_matches_the_cpu(dev, net):
    from geomconsistentfr_torch.models.lpips import LPIPSMetric

    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.1, size=gt.shape), 0, 1).astype(np.float32)
    maps = {d: LPIPSMetric(allow_random_trunk=True, net=net, device=d).batch(torch.from_numpy(gt),
                                                                              torch.from_numpy(pred)).cpu()
            for d in ("cuda", "cpu")}
    assert (maps["cuda"] - maps["cpu"]).abs().max().item() <= 1e-4 * maps["cpu"].abs().max().item()


def test_s3fd_heads_on_the_card_match_the_cpu(dev):
    from geomconsistentfr_torch.models.s3fd import S3FD, heads

    img = np.random.default_rng(2).integers(0, 256, (228, 228, 3)).astype(np.uint8)
    model = S3FD(generator=torch.Generator().manual_seed(3))
    cpu = heads(model, img)
    card = heads(model.to(dev), img)
    for i, (g, w) in enumerate(zip(card, cpu)):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), i


def test_cli_train_epoch_equals_an_in_process_trainer(dev, tmp_path, capsys):
    """`cli train` of one-batch epochs with the set on the card: epoch 0's losses (its first
    step's, which precede any update) are an in-process streaming Trainer's."""
    import json

    from geomconsistentfr_torch import cli
    from geomconsistentfr_torch.data.celebahq import CelebAHQRelightingData
    from geomconsistentfr_torch.train import Trainer

    (tmp_path / "cache").mkdir()
    cache = u8_cache(tmp_path / "cache")
    config = {"render": {"img_height": 32, "img_width": 32, "num_sample_points": 16, "t_stop": 0.105},
              "train": {"batch_size": 2, "batches_per_epoch": 1, "data_residency": "device"}}
    (tmp_path / "cfg.json").write_text(json.dumps(config))
    assert cli.main(["train", "--config", str(tmp_path / "cfg.json"), "--data", cache, "--epochs", "2",
                     "--out", str(tmp_path / "run")]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    trainer = Trainer(small_train_cfg(batches_per_epoch=1, data_residency="stream"), CelebAHQRelightingData(cache),
                      workdir=str(tmp_path / "ref"))
    _, want = trainer.run_epoch(trainer.init_or_resume(), 0)
    assert [m["epoch"] for m in lines] == [0, 1]
    for k in want:
        if k != "seconds":
            assert lines[0][k] == want[k], k

"""The port's differentiable march K4 (plain path, CPU) against the JAX package.

`shadows_cuda.RayMarchMinDistance` on CPU tensors runs the plain argmin march
forward and `shadows.march_vjp` backward: the structure kernel K2 and kernel
march_grad run on the card (tests/test_torch_cuda.py holds those to this
path). Inputs are 64x64 cosine terrain with a face mask, 16 samples, lights
outside and inside the image, a seeded random cotangent. Held against:
  * jax.vjp of JAX's vmapped gather evaluator `sample_distance_at` (the
    one-hot veto, as the custom VJP's backward vetoes whatever the forward's
    veto) at JAX's own t*, on the pixels whose t* the two marches agree on (the cotangent
    is zeroed elsewhere on both sides): d_depth |d| <= 1e-3 * max |d_depth|,
    d_light |d| <= 2e-4 * max |d_light| of its image. The two compute the
    same float32 formula, but near a zero distance the cross product of BA
    (~1) and BC (~4000) cancels, and so do the products of its backward:
    one ulp of another evaluation order (XLA fuses a*b - c*d into an FMA)
    there moves a pixel's gradient far more than one ulp of it. This scene
    gives 3.7e-4 and 6.3e-5;
  * jax.grad of JAX's pure march (autograd through the min over all
    samples), with the tie bars of tests/test_shadows_pallas.py:144-149: a
    tie of two samples' distances splits JAX's gradient between them, the
    port gives it to the first winner, as the reference's torch.min does.
    The lights are far, as training's are (light_distance times a unit
    vector);
  * the Pallas custom VJP `ray_march_min_distance_pallas_vjp` in interpret
    mode, as tests/test_shadows_pallas.py:113-125 runs it, leaving out the
    pixels whose winning sample lands a shifted coordinate on an exact
    integer (there the reference's floor/ceil taps, kept by the port, and
    the kernel's hat taps differ by design; ROADMAP queue 3): the same
    bars as against the gather evaluator, under each of the four vetoes of
    the forward.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.ops import shadows as TS
from geomconsistentfr_torch.ops import cuda_lib, shadows_cuda
from geomconsistentfr_torch.render import render as t_render
from geomconsistentfr_torch.render import shadow_min_distance
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu.ops import shadows as JS
from geomconsistentfr_tpu.ops import shadows_pallas as JSP
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

GRID = dict(img_height=64, img_width=64, num_sample_points=16, t_start=0.025, t_stop=0.105, march_chunk=16)
LIGHTS = np.asarray(
    [[1203.9, 1605.2, 3475.3], [-2407.8, 401.3, 3170.3], [5.0, -3.0, 20.0], [0.0, 3000.0, 900.0]], np.float32
)
FAR_LIGHTS = np.asarray(
    [[1203.9, 1605.2, 3475.3], [-2407.8, 401.3, 3170.3], [-1500.0, -2200.0, 2900.0], [0.0, 3000.0, 900.0]],
    np.float32,
)
# The bars against JAX's float32 evaluators (see the module docstring).
REL_D, REL_L = 1e-3, 2e-4


def cfgs(**kw):
    return JC.RenderConfig(**GRID, **kw), TC.RenderConfig(**GRID, **kw)


def scene(seed=0, b=4, size=64):
    """Smooth cosine terrain plus noise, an oval face mask with holes, and a cotangent."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    depth = np.zeros((b, size, size), np.float32)
    for i in range(b):
        for _ in range(6):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            depth[i] += rng.uniform(5, 15) * np.cos(2 * np.pi * fx * xx / size + ph[0]) * np.cos(
                2 * np.pi * fy * yy / size + ph[1])
    depth += rng.normal(size=depth.shape).astype(np.float32)
    face = ((xx - 0.47 * size) / (0.31 * size)) ** 2 + ((yy - 0.53 * size) / (0.4 * size)) ** 2 <= 1.0
    mask = (face & (rng.uniform(size=(b, size, size)) > 0.03)).astype(np.float32)
    g = rng.normal(size=(b, size, size)).astype(np.float32)
    return depth, mask, LIGHTS[:b].copy(), g


def port_grads(depth, mask, lights, g, tcfg):
    """(d_depth, d_light, t*) of the port's differentiable march, plain path."""
    d = torch.from_numpy(depth).requires_grad_()
    lp = torch.from_numpy(lights).requires_grad_()
    out = shadows_cuda.RayMarchMinDistance.apply(d, torch.from_numpy(mask), lp, tcfg)
    (out * torch.from_numpy(g)).sum().backward()
    _, t_star = TS.ray_march_min_distance_batch(*map(torch.from_numpy, (depth, mask, lights)), tcfg,
                                                return_argmin_t=True)
    return d.grad.numpy(), lp.grad.numpy(), t_star.numpy()


def assert_grads_close(got_d, got_l, want_d, want_l):
    assert np.abs(got_d - want_d).max() <= REL_D * np.abs(want_d).max()
    scale = np.abs(want_l).max(axis=1, keepdims=True)
    assert (np.abs(got_l - want_l) <= REL_L * scale).all(), (got_l, want_l)


def jax_vjp_at(depth, mask, lights, t_star, g, jcfg, evaluator=JS.sample_distance_at):
    """jax.vjp of JAX's per-image evaluator at the per-pixel offsets t_star (compiled)."""

    @jax.jit
    def vjp(d, lp, t, gg):
        def dist(dd, ll):
            return jax.vmap(lambda a, m, l, tt: evaluator(a, m, l, tt, jcfg))(dd, jnp.asarray(mask), ll, t)

        _, pullback = jax.vjp(dist, d, lp)
        return pullback(gg)

    gd, gl = vjp(jnp.asarray(depth), jnp.asarray(lights), jnp.asarray(t_star), jnp.asarray(g))
    return np.asarray(gd), np.asarray(gl)


@pytest.mark.parametrize("veto", ["onehot", "bilinear"])
def test_plain_vjp_matches_jax_vjp_at_tstar(veto):
    """JAX's t*: its pure march under the one-hot veto; under the bilinear
    veto, which only the Pallas kernel has, the kernel in interpret mode.
    The backward vetoes one-hot under both, as `_vjp_bwd` does."""
    depth, mask, lights, g = scene(seed=1)
    jcfg, tcfg = cfgs(shadow_mask_gather=veto)
    j_in = (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights))
    if veto == "onehot":
        _, jt = JS.ray_march_min_distance_batch(*j_in, jcfg, return_argmin_t=True)
    else:
        _, jt = JSP.ray_march_min_distance_pallas(*j_in, jcfg, return_argmin_t=True, interpret=True)
    jt = np.asarray(jt)
    _, _, tt = port_grads(depth, mask, lights, g, tcfg)
    agree = tt == jt
    assert agree.mean() >= 0.999
    g = np.where(agree, g, 0.0).astype(np.float32)
    got_d, got_l, _ = port_grads(depth, mask, lights, g, tcfg)
    want_d, want_l = jax_vjp_at(depth, mask, lights, jt, g, jcfg)
    assert_grads_close(got_d, got_l, want_d, want_l)


def test_plain_vjp_matches_jax_grad_of_the_pure_march():
    depth, mask, _, _ = scene(seed=2)
    lights = FAR_LIGHTS
    jcfg, tcfg = cfgs()

    def loss(d, lp):
        return jnp.sum(jnp.tanh(JS.ray_march_min_distance_batch(d, jnp.asarray(mask), lp, jcfg)))

    want_d, want_l = jax.grad(loss, argnums=(0, 1))(jnp.asarray(depth), jnp.asarray(lights))
    d = torch.from_numpy(depth).requires_grad_()
    lp = torch.from_numpy(lights).requires_grad_()
    torch.tanh(shadows_cuda.RayMarchMinDistance.apply(d, torch.from_numpy(mask), lp, tcfg)).sum().backward()
    diff = np.abs(d.grad.numpy() - np.asarray(want_d))
    assert (diff < 5e-4).mean() > 0.995, float(diff.max())
    assert diff.mean() < 1e-3
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(want_l), rtol=0.02, atol=1e-3)


def integer_tap_pixels(depth, mask, lights, t_star, cfg):
    """(B, H, W) bool: the pixel's sample at t* lands its shifted x or y on an integer."""
    sc = TS._Scene(*map(torch.from_numpy, (depth, mask, lights)), cfg)
    t = torch.from_numpy(t_star)[:, None]
    xt = TS._fma(t, sc.diff_x, sc.xx) + cfg.half_w - TS.EPS
    yt = (cfg.half_h - TS._fma(t, sc.diff_y, sc.yy)) - TS.EPS
    return ((xt == torch.floor(xt)) | (yt == torch.floor(yt)))[:, 0].numpy()


@pytest.mark.parametrize("veto", ["onehot", "bilinear", "hat", "hat_y"])
def test_plain_vjp_matches_the_pallas_vjp_in_interpret_mode(monkeypatch, veto):
    """Under every veto of the forward; the backward of both vetoes the winner one-hot."""
    monkeypatch.setattr(JSP, "ray_march_min_distance_pallas",
                        functools.partial(JSP.ray_march_min_distance_pallas, interpret=True))
    depth, mask, lights, g = scene(seed=3)
    jcfg, tcfg = cfgs(shadow_mask_gather=veto)
    _, jt = JSP.ray_march_min_distance_pallas(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jcfg,
                                              return_argmin_t=True)
    jt = np.asarray(jt)
    _, _, tt = port_grads(depth, mask, lights, g, tcfg)
    hat = integer_tap_pixels(depth, mask, lights, tt, tcfg)
    assert hat.mean() <= 1e-3
    keep = (tt == jt) & ~hat
    assert keep.mean() >= 0.998
    g = np.where(keep, g, 0.0).astype(np.float32)

    def loss(d, lp):
        return jnp.sum(JSP.ray_march_min_distance_pallas_vjp(d, jnp.asarray(mask), lp, jcfg) * g)

    want_d, want_l = jax.grad(loss, argnums=(0, 1))(jnp.asarray(depth), jnp.asarray(lights))
    got_d, got_l, _ = port_grads(depth, mask, lights, g, tcfg)
    assert_grads_close(got_d, got_l, np.asarray(want_d), np.asarray(want_l))


@pytest.mark.parametrize("gate", ["none", "inside_image", "wide"])
@pytest.mark.parametrize("veto", ["onehot", "bilinear"])
def test_culled_pixels_get_no_gradient_and_the_gate_none(veto, gate):
    """Cull on equals cull off with the cotangent zeroed in culled blocks; the gate bias is a constant."""
    depth, mask, lights, g = scene(seed=4)
    mask[1, :24] = 0.0
    mask[2, :, 40:] = 0.0
    _, base = cfgs(shadow_mask_gather=veto)
    _, culled = cfgs(shadow_mask_gather=veto, shadow_mask_cull=True, shadow_col_chunk=16, shadow_bias_gate=gate)
    live = TS._live_pixels(torch.from_numpy(mask), culled).numpy()
    assert 0.0 < live.mean() < 1.0
    got_d, got_l, _ = port_grads(depth, mask, lights, g, culled)
    want_d, want_l, _ = port_grads(depth, mask, lights, np.where(live, g, 0.0).astype(np.float32), base)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_l, want_l)


def test_mask_gets_no_gradient_and_forward_is_the_march():
    depth, mask, lights, g = scene(seed=5)
    _, tcfg = cfgs()
    d, m, lp = (torch.from_numpy(a).requires_grad_() for a in (depth, mask, lights))
    before = dict(cuda_lib.LAUNCHES)
    out = shadows_cuda.ray_march_min_distance_cuda(d, m, lp, tcfg)
    assert isinstance(out.grad_fn, shadows_cuda.RayMarchMinDistance._backward_cls)
    np.testing.assert_array_equal(
        out.detach().numpy(), TS.ray_march_min_distance_batch(*map(torch.from_numpy, (depth, mask, lights)), tcfg).numpy())
    (out * torch.from_numpy(g)).sum().backward()
    assert m.grad is None and d.grad is not None and lp.grad is not None
    assert cuda_lib.LAUNCHES == before
    # The wrapper on CPU tensors is the plain VJP at t*.
    _, t_star = TS.ray_march_min_distance_batch(*map(torch.from_numpy, (depth, mask, lights)), tcfg,
                                                return_argmin_t=True)
    ts = torch.from_numpy(TS.sample_ts(tcfg).astype(np.float32))
    idx = torch.searchsorted(ts, t_star).to(torch.int32)
    want_d, want_l = shadows_cuda.march_grad_cuda(
        *map(torch.from_numpy, (depth, mask, lights)), idx, ts, torch.from_numpy(g), tcfg)
    np.testing.assert_array_equal(d.grad.numpy(), want_d.numpy())
    np.testing.assert_array_equal(lp.grad.numpy(), want_l.numpy())


def test_draft_tier_refuses_a_gradient():
    depth, mask, lights, _ = scene(seed=6)
    tcfg = TC.RenderConfig(img_height=64, img_width=64, num_sample_points=32, t_start=0.025, t_stop=0.185,
                           shadow_resolution_scale=2, shadow_refine_halfwidth=4, shadow_lowres_t_stride=2)
    d = torch.from_numpy(depth).requires_grad_()
    m, lp = torch.from_numpy(mask), torch.from_numpy(lights)
    with pytest.raises(NotImplementedError):
        shadow_min_distance(d, m, lp, tcfg)
    with pytest.raises(NotImplementedError):
        shadows_cuda.RayMarchMinDistance.apply(d, m, lp, tcfg)
    with pytest.raises(NotImplementedError):
        shadows_cuda.refine_min_distance_cuda(d, m, lp, torch.full_like(d, 0.1), tcfg)
    with pytest.raises(NotImplementedError):
        t_render(torch.rand(4, 64, 64, 3), d, torch.zeros(4, 4), m, tcfg, target_light=lp)
    # Without a gradient the draft tier serves as before.
    with torch.no_grad():
        assert torch.isfinite(shadow_min_distance(d, m, lp, tcfg)).all()
    full = dataclasses.replace(tcfg, shadow_resolution_scale=1, shadow_refine_halfwidth=0, shadow_lowres_t_stride=1)
    assert shadow_min_distance(d, m, lp, full).requires_grad

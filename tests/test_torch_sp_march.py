"""The port's sample-sharded march against the JAX package, on CPU ranks (gloo).

Each case spawns 2 or 4 ranks (parallel.distributed.spawn, file:// rendezvous
in tmp_path; workers in tests/torch_parallel_child.py), while the test process
computes JAX's side on the suite's virtual 8-device mesh.
  * K5, `RayMarchMinDistanceSP` (plain path on the CPU), on 2 ranks (16
    samples) and 4 ranks (15 samples: the last shard holds one pad), 32x32,
    cosine terrain, one image whose mask is all zeros (every shard ties at
    the sentinel: the first winner, the grid's first offset, must win). Held
    to: the full-grid plain march, bit for bit (the MIN is exact), and its
    first winner's t on >= 0.9999 of pixels; one collective a forward (the
    MIN of the packed (distance, t) keys), none in the backward; every rank
    the same bits; JAX's
    `ray_march_min_distance_pallas_vjp_sp` under shard_map: the distances
    at the march bars, t* on >= 0.998 of pixels, jax.grad in depth and the
    light at the bars of tests/test_torch_train_march.py, with the pixels
    whose winning sample lands on an exact integer coordinate (ROADMAP queue
    3) or whose t* differs left out of the cotangent on both sides.
  * `Relighter(mesh, parallel=...)`: 'samples' on 2 ranks and 'grid' on a
    2x2 mesh at strict and draft, 32x32, 12 samples: bit-equal to the port's
    single-process Relighter (forward, visuals, sweeps, estimate_lighting),
    and against JAX's Relighter(mesh, parallel=...) at the bars of
    tests/test_parallel.py:121-318 (every field within 5e-4; min_distance
    within 1e-5 at strict) where the two CNNs' rounding allows, and the
    port-vs-JAX draft bar of tests/test_torch_infer.py (rendered PSNR >= 40
    dB, bf16 CNN activations; both with the one-hot veto, JAX's off the TPU).
    'data' on 2 ranks: bit-equal to the single process.
  * `sharded_sample_ts` equal to JAX's for 1-8 shards; BatchNorm over a
    group of 2 equal to JAX's TorchBatchNorm under shard_map with axis_name,
    and its gradients, averaged over the ranks, equal to one process's on the
    whole batch.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import torch_parallel_child as child
from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.convert import state_dict_from_jax_variables
from geomconsistentfr_torch.infer import Relighter as TRelighter
from geomconsistentfr_torch.models.layers import BatchNorm
from geomconsistentfr_torch.ops import shadows as TS
from geomconsistentfr_torch.ops import shadows_cuda
from geomconsistentfr_torch.parallel import distributed
from geomconsistentfr_torch.parallel import mesh as TM
from geomconsistentfr_torch.render import render as t_render
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu.infer import Relighter as JRelighter
from geomconsistentfr_tpu.models.layers import TorchBatchNorm
from geomconsistentfr_tpu.ops import shadows as JS
from geomconsistentfr_tpu.ops import shadows_pallas as JSP
from geomconsistentfr_tpu.parallel.mesh import make_mesh, make_mesh_grid, shard_map_fn
from test_torch_infer import random_variables
from test_torch_train_march import assert_grads_close, integer_tap_pixels, scene
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

GRIDS = {2: dict(num_sample_points=16, t_start=0.025, t_stop=0.105), 4: dict(num_sample_points=15, t_start=0.03,
                                                                              t_stop=0.105)}


def load(tmp, tag, n):
    return [torch.load(tmp / f"{tag}_rank{r}.pt", weights_only=False) for r in range(n)]


def wait(ctx):
    while not ctx.join():
        pass


def assert_march_close(got, want):
    """The repo's kernel bars (tests/test_shadows_pallas.py:44-51)."""
    big_w, big_g = want >= 1e5, got >= 1e5
    assert (big_w == big_g).mean() >= 0.9999
    diff = np.abs(got - want)[~(big_w | big_g)]
    assert np.quantile(diff, 0.9999) < 1e-3 and diff.mean() < 1e-4, diff.max()


def ranks_identical(results, keys):
    for r in results[1:]:
        for k in keys:
            assert torch.equal(r[k], results[0][k]), k


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def k5_scene(n):
    grid = dict(img_height=32, img_width=32, march_chunk=16, **GRIDS[n])
    depth, mask, lights, g = scene(seed=10 + n, b=4, size=32)
    mask[3] = 0.0  # every sample vetoed: the shards tie at the sentinel
    return JC.RenderConfig(**grid), TC.RenderConfig(**grid), depth, mask, lights, g


def jax_sp(jcfg, n):
    """JAX's K5 under shard_map over n devices: f(depth, mask, lights, g) -> (distances, t*, d_depth, d_light)."""
    mesh = JMesh(np.asarray(jax.devices()[:n]), ("s",))
    ts = jnp.asarray(JS.sharded_sample_ts(jcfg, n))

    def local(d, m, lp, ts_local, gg):
        out, res = JSP._vjp_fwd_sp(d, m, lp, jcfg, "s", ts_local)

        def loss(dd, ll):
            return jnp.sum(JSP.ray_march_min_distance_pallas_vjp_sp(dd, m, ll, jcfg, "s", ts_local) * gg)

        gd, gl = jax.grad(loss, argnums=(0, 1))(d, lp)
        return out, res[3], gd, gl

    f = jax.jit(shard_map_fn(local, mesh, in_specs=(P(), P(), P(), P("s"), P()), out_specs=(P(), P(), P(), P())))

    def run(depth, mask, lights, g):
        return [np.asarray(a) for a in f(*map(jnp.asarray, (depth, mask, lights)), ts, jnp.asarray(g))]

    return run


@pytest.fixture(scope="module")
def k5_runs(tmp_path_factory):
    """Both worlds' K5 ranks, spawned first and joined after JAX's side is computed."""
    tmp = tmp_path_factory.mktemp("k5")
    runs, ctxs = {}, []
    for n in (2, 4):
        jcfg, tcfg, depth, mask, lights, g = k5_scene(n)
        # The pixels the JAX comparison keeps: the same winner on the full
        # grid (port) and in JAX's sharded combine, off the integer taps.
        full_d, full_idx = TS.ray_march_argmin_batch(*map(torch.from_numpy, (depth, mask, lights)), tcfg)
        ts = TS.sample_ts(tcfg).astype(np.float32)
        jax_run = jax_sp(jcfg, n)
        _, jax_t, _, _ = jax_run(depth, mask, lights, np.zeros_like(g))
        full_t = ts[full_idx.numpy()]
        keep = (full_t == jax_t) & ~integer_tap_pixels(depth, mask, lights, full_t, tcfg)
        g = np.where(keep, g, 0.0).astype(np.float32)
        ctxs.append(distributed.spawn(child.k5, n, "cpu", str(tmp / f"rdzv{n}"), join=False,
                                      args=(str(tmp), f"k5_{n}", tcfg, depth, mask, lights, g)))
        runs[n] = dict(tcfg=tcfg, depth=depth, mask=mask, lights=lights, g=g, keep=keep, full_d=full_d.numpy(),
                       full_idx=full_idx.numpy(), jax=jax_run(depth, mask, lights, g))
    for n, ctx in zip((2, 4), ctxs):
        wait(ctx)
        runs[n]["ranks"] = load(tmp, f"k5_{n}", n)
    return runs


@pytest.mark.parametrize("n", [2, 4])
def test_k5_forward_is_the_full_grid_march_on_every_rank(k5_runs, n):
    run = k5_runs[n]
    ranks = run["ranks"]
    ranks_identical(ranks, ("out", "d_depth", "d_light", "t_star", "served", "served_t", "served_min"))
    r = ranks[0]
    np.testing.assert_array_equal(r["out"].numpy(), run["full_d"])
    np.testing.assert_array_equal(r["served"].numpy(), run["full_d"])
    np.testing.assert_array_equal(r["served_min"].numpy(), run["full_d"])
    # t* is an offset of the padded global table; the served t* is K5's.
    assert np.isin(r["t_star"].numpy(), TS.sharded_sample_ts(run["tcfg"], n)).all()
    np.testing.assert_array_equal(r["served_t"].numpy(), r["t_star"].numpy())
    # One MIN of the int64 keys a forward, 8 bytes a pixel, and no collective in the backward.
    for rank in ranks:
        assert rank["collectives"] == 1 and rank["collective_bytes"] == 8 * run["full_d"].size
        assert rank["t_star"].dtype == torch.float32


@pytest.mark.parametrize("n", [2, 4])
def test_k5_winner_is_the_full_grid_first_winner(k5_runs, n):
    run = k5_runs[n]
    t_star = run["ranks"][0]["t_star"].numpy()
    ts = TS.sample_ts(run["tcfg"]).astype(np.float32)
    assert (t_star == ts[run["full_idx"]]).mean() >= 0.9999
    # The all-vetoed image: every shard reaches the sentinel; the first shard's first sample wins.
    assert (run["full_d"][3] >= 1e5).all() and (t_star[3] == ts[0]).all()
    assert (run["jax"][1][3] == ts[0]).all()


@pytest.mark.parametrize("n", [2, 4])
def test_k5_matches_jax_vjp_sp(k5_runs, n):
    run = k5_runs[n]
    j_out, j_t, j_dd, j_dl = run["jax"]
    r = run["ranks"][0]
    assert_march_close(r["out"].numpy(), j_out)
    assert (r["t_star"].numpy() == j_t).mean() >= 0.998
    assert run["keep"].mean() >= 0.99
    assert np.abs(j_dd).max() > 0
    assert_grads_close(r["d_depth"].numpy(), r["d_light"].numpy(), j_dd, j_dl)


# ---------------------------------------------------------------------------
# Relighter(mesh, parallel=...)
# ---------------------------------------------------------------------------

SMALL = dict(img_height=32, img_width=32, num_sample_points=12, t_stop=0.085, march_chunk=12)


def relight_cfgs(module):
    """strict and draft at 32x32, 12 samples. The draft tier takes the one-hot
    veto, which is what JAX's draft runs off the TPU (ROADMAP queue 3), so
    that the two differ only by their bf16 CNNs."""
    out = {}
    for tier in ("strict", "draft"):
        cfg = module.apply_precision_tier(module.preset_single_image(), tier)
        extra = dict(use_pallas_shadows=False) if module is JC else {}
        if tier == "draft":
            extra.update(shadow_mask_gather="onehot", shadow_step_pack=1)
        out[tier] = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **SMALL, **extra))
    return out


def relight_inputs(b=4, seed=13):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, 32, 32, 3)).astype(np.float32)
    masks = np.zeros((b, 32, 32), np.float32)
    masks[:, 6:28, 4:26] = 1.0
    masks *= (rng.uniform(size=(b, 32, 32)) > 0.1)
    lights = rng.normal(size=(b, 3)).astype(np.float32)
    lights[:, 2] = np.abs(lights[:, 2]) + 0.3
    lights /= np.linalg.norm(lights, axis=1, keepdims=True)
    ambients = np.full((b,), 0.5, np.float32)
    sweep = rng.normal(size=(5, 3)).astype(np.float32)
    sweep[:, 2] = np.abs(sweep[:, 2]) + 0.3
    return images, masks, lights, ambients, sweep


@pytest.fixture(scope="module")
def relighter_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("relight")
    variables = random_variables("target")
    state = state_dict_from_jax_variables(variables)
    tcfgs, jcfgs = relight_cfgs(TC), relight_cfgs(JC)
    inputs = relight_inputs()
    images, masks, lights, ambients, sweep = inputs
    worlds = {2: [("samples", (2,)), ("data", (2,))], 4: [("grid", (2, 2))]}
    ctxs = {n: distributed.spawn(child.relighter, n, "cpu", str(tmp / f"rdzv{n}"), join=False,
                                 args=(str(tmp), f"rl_{n}", jobs, tcfgs, state, *inputs))
            for n, jobs in worlds.items()}

    # The port in one process, and JAX on meshes of the same shapes.
    single = {}
    for name, cfg in tcfgs.items():
        rl = TRelighter(cfg, state, device="cpu")
        single[name] = dict(
            forward=rl.forward(images, masks, lights, ambients)._asdict(),
            visuals=rl.forward_visuals(images, masks, lights, ambients),
            sweep=rl.relight_sweep(images[0], masks[0], sweep).rendered,
            sweep_u8=rl.relight_sweep_rendered_u8(images[0], masks[0], sweep),
            lighting={"data": rl.estimate_lighting(images), "other": rl.estimate_lighting(images[:3])},
        )
    meshes = {"samples": make_mesh(jax.devices()[:2]), "grid": make_mesh_grid(2, 2)}
    jax_out = {}
    for parallel, tier in (("samples", "strict"), ("samples", "draft"), ("grid", "strict")):
        rl = JRelighter(jcfgs[tier], variables, mesh=meshes[parallel], parallel=parallel)
        jax_out[parallel, tier] = dict(forward=rl.forward(images, masks, lights, ambients)._asdict(),
                                       sweep=rl.relight_sweep(images[0], masks[0], sweep).rendered)
    ranks = {}
    for n, ctx in ctxs.items():
        wait(ctx)
        ranks.update({job[0]: [r["results"] for r in load(tmp, f"rl_{n}", n)] for job in worlds[n]})
    return dict(single=single, jax=jax_out, ranks=ranks)


def assert_equal_tree(got, want, where):
    if isinstance(want, dict):
        for k in want:
            assert_equal_tree(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (tuple, list)):
        for i, (a, b) in enumerate(zip(got, want)):
            assert_equal_tree(a, b, f"{where}[{i}]")
    else:
        assert torch.equal(got, want), where


@pytest.mark.parametrize("tier", ["strict", "draft"])
@pytest.mark.parametrize("parallel", ["samples", "grid", "data"])
def test_relighter_parallel_is_bit_equal_to_one_process(relighter_runs, parallel, tier):
    single = relighter_runs["single"][tier]
    for rank in relighter_runs["ranks"][parallel]:
        got = rank[parallel, tier]
        for key in ("forward", "visuals", "sweep", "sweep_u8"):
            assert_equal_tree(got[key], single[key], f"{parallel}/{tier}/rank {key}")
        assert_equal_tree(got["lighting"], single["lighting"]["data" if parallel == "data" else "other"],
                          f"{parallel}/{tier}/lighting")


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-30))


@pytest.mark.parametrize("parallel, tier", [("samples", "strict"), ("samples", "draft"), ("grid", "strict")])
def test_relighter_parallel_matches_jax(relighter_runs, parallel, tier):
    got = relighter_runs["ranks"][parallel][0][parallel, tier]
    want = relighter_runs["jax"][parallel, tier]
    if tier == "draft":
        assert psnr(got["forward"]["rendered"].numpy(), want["forward"]["rendered"]) >= 40.0
        assert psnr(got["sweep"].numpy(), want["sweep"]) >= 40.0
        return
    for field, w in want["forward"].items():
        np.testing.assert_allclose(got["forward"][field].numpy(), np.asarray(w), atol=5e-4, err_msg=field)
    np.testing.assert_allclose(got["forward"]["min_distance"].numpy(), np.asarray(want["forward"]["min_distance"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["sweep"].numpy(), np.asarray(want["sweep"]), atol=5e-4)


def test_relighter_refuses_what_jax_refuses():
    cfg = relight_cfgs(TC)["strict"]
    state = state_dict_from_jax_variables(random_variables("target"))
    with pytest.raises(ValueError, match="unknown parallel mode"):
        TRelighter(cfg, state, device="cpu", parallel="tensor")
    one = TM.make_mesh("cpu")
    with pytest.raises(ValueError, match="2-D"):
        TRelighter(cfg, state, mesh=one, parallel="grid")


# ---------------------------------------------------------------------------
# sharded_sample_ts and cross-replica BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", range(1, 9))
def test_sharded_sample_ts_equals_jax(n_shards):
    for preset in ("preset_target_lighting_train", "preset_lighting_transfer"):
        got = TS.sharded_sample_ts(getattr(TC, preset)().render, n_shards)
        want = JS.sharded_sample_ts(getattr(JC, preset)().render, n_shards)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert got.shape[0] % n_shards == 0


def test_batchnorm_over_a_group_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 3, 8, 8)) * 2 + 1).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    ctx = distributed.spawn(child.batchnorm, 2, "cpu", str(tmp_path / "rdzv"), join=False,
                            args=(str(tmp_path), "bn", x, cot, 0.1))

    # JAX: TorchBatchNorm with axis_name under shard_map, the batch split over 2 devices.
    bn = TorchBatchNorm(features=3, axis_name="data")
    variables = bn.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), use_running_average=True)
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("data",))

    def local(v, xx):
        return bn.apply(v, xx, use_running_average=False, mutable=["batch_stats"])

    y, stats = jax.jit(shard_map_fn(local, mesh, in_specs=(P(), P("data")), out_specs=(P("data"), P())))(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    # One process, the whole batch: the gradients the ranks' average must give.
    one = BatchNorm(3, momentum=0.1)
    xs = torch.from_numpy(x).requires_grad_()
    (one(xs) * torch.from_numpy(cot)).sum().backward()

    wait(ctx)
    ranks = load(tmp_path, "bn", 2)
    ranks_identical(ranks, ("running_mean", "running_var", "weight_grad", "bias_grad"))
    got_y = torch.cat([r["y"] for r in ranks]).numpy()
    np.testing.assert_allclose(got_y, np.asarray(y).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["running_mean"].numpy(), np.asarray(stats["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ranks[0]["running_var"].numpy(), np.asarray(stats["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ranks[0]["weight_grad"].numpy(), one.weight.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["bias_grad"].numpy(), one.bias.grad.numpy(), rtol=1e-5, atol=1e-5)
    # The input's gradient on each rank is its slice's, times the group's size (all_sum's backward).
    got_dx = torch.cat([r["x_grad"] for r in ranks]).numpy() / 2
    np.testing.assert_allclose(got_dx, xs.grad.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# One process: K5 without a group, render's march_fn hook
# ---------------------------------------------------------------------------


def test_k5_without_a_group_is_the_differentiable_march():
    """A march over given offsets that needs a gradient is K5 with no group: the full grid's K4, bit for bit."""
    _, tcfg, depth, mask, lights, g = k5_scene(2)
    ts = TS.sample_ts(tcfg).astype(np.float32)
    m = torch.from_numpy(mask)
    d1, l1, d2, l2 = (torch.from_numpy(a).requires_grad_() for a in (depth, lights, depth, lights))
    out1 = shadows_cuda.ray_march_min_distance_cuda(d1, m, l1, tcfg, ts=ts)
    assert isinstance(out1.grad_fn, shadows_cuda.RayMarchMinDistanceSP._backward_cls)
    out2 = shadows_cuda.RayMarchMinDistance.apply(d2, m, l2, tcfg)
    (out1 * torch.from_numpy(g)).sum().backward()
    (out2 * torch.from_numpy(g)).sum().backward()
    assert torch.equal(out1, out2) and torch.equal(d1.grad, d2.grad) and torch.equal(l1.grad, l2.grad)
    with pytest.raises(NotImplementedError):
        shadows_cuda.ray_march_min_distance_cuda(d1, m, l1, tcfg, ts=ts, return_argmin_t=True)
    with pytest.raises(NotImplementedError):
        shadows_cuda.sharded_march(d1, m, l1, tcfg, ts, None, return_argmin_t=True)


@pytest.mark.parametrize("tier", ["strict", "draft"])
def test_render_march_fn_replaces_the_march_and_the_refine(tier):
    """render(march_fn=...) calls the hook at the march's resolution (with
    return_argmin_t under the draft refine) and its refine_fn; a hook that
    marches the whole grid as one shard renders bit for bit as render() alone."""
    cfg = relight_cfgs(TC)[tier].render
    mcfg = TS.scaled_render_cfg(cfg) if cfg.shadow_resolution_scale > 1 else cfg
    images, masks, lights, ambients, _ = relight_inputs()
    rng = np.random.default_rng(3)
    albedo = torch.from_numpy(images)
    depth = torch.from_numpy((rng.normal(size=masks.shape) * 5 - 30).astype(np.float32))
    args = (albedo, depth, torch.zeros((4, 4)), torch.from_numpy(masks), cfg)
    targets = dict(target_light=torch.from_numpy(lights), target_ambient=torch.from_numpy(ambients))
    calls = []

    def march(d, m, lp, return_argmin_t=False):
        calls.append(("march", tuple(d.shape), return_argmin_t))
        return shadows_cuda.sharded_march(d, m, lp, mcfg, TS.sample_ts(mcfg), None, return_argmin_t)

    def refine(d, m, lp, t_map):
        calls.append(("refine", tuple(d.shape)))
        return shadows_cuda.refine_min_distance_cuda(d, m, lp, t_map, cfg)

    march.refine_fn = refine
    got = t_render(*args, **targets, march_fn=march)
    want = t_render(*args, **targets)
    for field in want._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    if tier == "strict":
        assert calls == [("march", (4, 32, 32), False)]
    else:
        assert calls == [("march", (4, 8, 8), True), ("refine", (4, 32, 32))]

"""The port's data-parallel and grid train steps against the JAX package, on CPU ranks (gloo).

The port's steps run in spawned ranks (parallel.distributed.spawn, file://
rendezvous in tmp_path; workers in tests/torch_parallel_child.py) while the
test process computes JAX's `make_data_parallel_step` and
`make_grid_parallel_step` on the suite's virtual 8-device mesh. Two steps of
tests/test_train.py's tiny configuration (32x32, 16 samples, batch 2, a face
mask with holes), the target variant from the same weights, at lr 1e-6 (the
rate tests/test_torch_train.py explains: at 1e-4 Adam turns rounding-level
gradients into +-lr updates). Meshes: 2x1 data parallel (world 2), 2x2 and
1x4 grids (world 4). Held:
  * every rank's parameters, BatchNorm statistics, Adam moments and
    gradients bit-identical after each step;
  * each against the port's single-process train_step on the global batch,
    at about ten times what this test measures: each loss within rtol 1e-4
    (measured 4.3e-6), the gradients within 1e-3 (sum |d| / sum |g|;
    1.4e-4: the BatchNorm moments summed in another order), the BatchNorm
    statistics within 1e-4 of their size (1.5e-5), the parameter updates
    within 2e-2 (sum |d| / sum |update|; 2.6e-3: a few Adam signs flip where
    a gradient is rounding). The 1x4 grid shards no data, so it is the
    single process bit for bit;
  * each against JAX's step of the same mesh: the loss bars of
    tests/test_train.py:113 and :408 (|d| < 5e-4) and rtol 1e-3, and the
    bars of tests/test_torch_train.py for the updates, statistics and
    moments;
  * the 2x2 grid against the 1x4 grid at tests/test_train.py:427-443's bars.
The Trainer with a mesh: one epoch on 2 ranks equals one process's, and only
rank 0 writes checkpoints and metrics. Last, the mesh and process helpers in
one process.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_parallel_child as child
from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch import train as TT
from geomconsistentfr_torch.convert import adam_moments_from_optax, state_dict_from_jax_variables
from geomconsistentfr_torch.data.celebahq import SyntheticFaceData
from geomconsistentfr_torch.parallel import distributed
from geomconsistentfr_torch.parallel import mesh as TM
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu import train as JT
from geomconsistentfr_tpu.parallel.mesh import device_put_sharded_batch, make_mesh, make_mesh_grid
from test_torch_sp_march import load, wait
from test_torch_train import LR, batch, sum_rel, tiny
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

STEPS = 2
SHAPES = {"dp2": (2,), "grid2x2": (2, 2), "grid1x4": (1, 4)}
USE_SKIPS = (False,) * 4


def masked_batch(rng):
    b = batch(rng, 2, 32)
    b["face_mask"] = (rng.uniform(size=(2, 32, 32)) > 0.2).astype(np.float32)
    return b


def jax_snapshot(state) -> dict:
    host = jax.device_get(state)
    out = {"g": state_dict_from_jax_variables({"params": host.params_g, "batch_stats": host.batch_stats_g}),
           "d": state_dict_from_jax_variables({"params": host.params_d, "batch_stats": host.batch_stats_d})}
    for name, opt in (("g", host.opt_g), ("d", host.opt_d)):
        out[f"{name}_mu"], out[f"{name}_nu"] = adam_moments_from_optax(opt[0].mu, opt[0].nu)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steps")
    jcfg, tcfg = tiny(JC.preset_target_lighting_train(), lr=LR), tiny(TC.preset_target_lighting_train(), lr=LR)
    rng = np.random.default_rng(2)
    batches = [masked_batch(rng) for _ in range(STEPS)]
    j0 = JT.init_state(jcfg, jax.random.PRNGKey(0))
    start = {k: v for k, v in jax_snapshot(j0).items() if k in ("g", "d")}
    worlds = {2: ["dp2"], 4: ["grid2x2", "grid1x4"]}
    ctxs = {n: distributed.spawn(child.train_steps, n, "cpu", str(tmp / f"rdzv{n}"), join=False,
                                 args=(str(tmp), f"steps{n}", [SHAPES[k] for k in names], tcfg, start, batches,
                                       USE_SKIPS))
            for n, names in worlds.items()}

    # The port in one process on the global batch.
    state = TT.init_state(tcfg, "cpu")
    child._load(state, start)
    single = dict(losses=[], states=[])
    for b in batches:
        single["losses"].append({k: float(v) for k, v in
                                 TT.train_step(state, TT.decode_batch(b, "cpu"), tcfg, USE_SKIPS).items()})
        single["states"].append(child._snapshot(state))

    # JAX's steps on meshes of the same shapes.
    jax_runs = {}
    for name, make, mesh in (("dp2", JT.make_data_parallel_step, make_mesh(jax.devices()[:2])),
                             ("grid2x2", JT.make_grid_parallel_step, make_mesh_grid(2, 2)),
                             ("grid1x4", JT.make_grid_parallel_step, make_mesh_grid(1, 4))):
        # Replicated on the mesh from the start, so that both steps trace once.
        step, s, run = make(jcfg, mesh), jax.device_put(j0, NamedSharding(mesh, P())), dict(losses=[], states=[])
        for b in batches:
            s, m = step(s, device_put_sharded_batch(b, mesh), USE_SKIPS)
            run["losses"].append({k: float(v) for k, v in m.items()})
            run["states"].append(jax_snapshot(s))
        jax_runs[name] = run

    ranks = {}
    for n, ctx in ctxs.items():
        wait(ctx)
        loaded = load(tmp, f"steps{n}", n)
        for name in worlds[n]:
            ranks[name] = [r["results"][SHAPES[name]] for r in loaded]
    return dict(single=single, jax=jax_runs, ranks=ranks, start=start)


def assert_same(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    else:
        assert torch.equal(a, b), where


@pytest.mark.parametrize("name", list(SHAPES))
def test_every_rank_holds_the_same_bits(runs, name):
    ranks = runs["ranks"][name]
    assert len(ranks) == int(np.prod(SHAPES[name]))
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for i in range(STEPS):
            assert_same(r["states"][i], ranks[0]["states"][i], f"{name} rank step {i}")
    # On CPU tensors every wrapper ran its plain version: no kernel launched.
    assert all(v == 0 for r in ranks for v in r["launches"].values())


def buffers(state_dict, suffix=("running_mean", "running_var")):
    return {k: v for k, v in state_dict.items() if k.endswith(suffix)}


def params(state_dict):
    return {k: v for k, v in state_dict.items() if not k.endswith(("running_mean", "running_var",
                                                                   "num_batches_tracked"))}


def updates(state, start):
    return {k: v - start[k] for k, v in params(state).items()}


@pytest.mark.parametrize("name", list(SHAPES))
def test_parallel_step_equals_one_process_on_the_global_batch(runs, name):
    got, want = runs["ranks"][name][0], runs["single"]
    if SHAPES[name][0] == 1:  # no data sharding: every reduction is the single process's
        assert got["losses"] == want["losses"]
        for i in range(STEPS):
            assert_same(got["states"][i], want["states"][i], f"{name} step {i}")
    for i in range(STEPS):
        for k, v in want["losses"][i].items():
            np.testing.assert_allclose(got["losses"][i][k], v, rtol=1e-4, err_msg=f"step {i} {k}")
        g, w = got["states"][i], want["states"][i]
        assert sum_rel(g["grads"], w["grads"]) <= 1e-3, i
        for m in ("g", "d"):
            for k, v in buffers(w[m]).items():
                assert (g[m][k] - v).abs().max().item() <= 1e-4 * v.abs().max().item(), (i, m, k)
            assert sum_rel(updates(g[m], runs["start"][m]), updates(w[m], runs["start"][m])) <= 2e-2, (i, m)


@pytest.mark.parametrize("name", list(SHAPES))
def test_parallel_step_matches_jax(runs, name):
    got, want = runs["ranks"][name][0], runs["jax"][name]
    bars = {"g": 4e-2, "d": 5e-3}
    for i in range(STEPS):
        for k, v in want["losses"][i].items():
            assert abs(got["losses"][i][k] - v) < 5e-4, (i, k, got["losses"][i][k], v)
            np.testing.assert_allclose(got["losses"][i][k], v, rtol=1e-3, err_msg=f"step {i} {k}")
        g, w = got["states"][i], want["states"][i]
        for m in ("g", "d"):
            assert sum_rel(updates(g[m], runs["start"][m]), updates(w[m], runs["start"][m])) <= bars[m], (i, m)
            for k, v in buffers(w[m]).items():
                assert (g[m][k] - v).abs().max().item() <= 1e-3 * v.abs().max().item(), (i, m, k)
            assert set(g[f"{m}_mu"]) == set(w[f"{m}_mu"])
            moment_bar = {"g": 1e-1, "d": 1e-2}[m]
            assert sum_rel(g[f"{m}_mu"], w[f"{m}_mu"]) <= moment_bar, (i, m)
            assert sum_rel(g[f"{m}_nu"], w[f"{m}_nu"]) <= moment_bar, (i, m)


def test_grid_shapes_agree(runs):
    """tests/test_train.py:424-443: the 2x2 and 1x4 grids run the same estimator."""
    a, b = runs["ranks"]["grid2x2"][0], runs["ranks"]["grid1x4"][0]
    for i in range(STEPS):
        for k, v in a["losses"][i].items():
            assert abs(b["losses"][i][k] - v) < 2e-5 + 2e-6 * abs(v), (i, k)
        for m in ("g", "d"):
            for k, v in params(a["states"][i][m]).items():
                np.testing.assert_allclose(params(b["states"][i][m])[k].numpy(), v.numpy(), atol=3e-4)


def test_trainer_with_a_mesh_equals_one_process(tmp_path):
    trainer_on_a_mesh_equals_one_process(tmp_path, "auto")


def test_trainer_with_a_mesh_streams_under_device_residency(tmp_path):
    trainer_on_a_mesh_equals_one_process(tmp_path, "device")


def trainer_on_a_mesh_equals_one_process(tmp_path, residency):
    """Both residencies stream on the two ranks (the JAX package's Trainer does so on a mesh of
    several devices); the one process keeps the set on its device."""
    cfg = tiny(TC.preset_target_lighting_train(), lr=LR)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batches_per_epoch=2, log_every_steps=1,
                                                             checkpoint_every_steps=0, data_residency=residency))
    ctx = distributed.spawn(child.trainer_epoch, 2, "cpu", str(tmp_path / "rdzv"), join=False,
                            args=(str(tmp_path), "trainer", (2,), cfg, str(tmp_path / "mesh"), 3))
    single = TT.Trainer(cfg, SyntheticFaceData(num_samples=8, size=32), workdir=str(tmp_path / "one"), device="cpu")
    state, avg = single.run_epoch(single.init_or_resume(torch.Generator().manual_seed(3)), 0)
    wait(ctx)
    ranks = load(tmp_path, "trainer", 2)
    assert all(r["streams"] for r in ranks) and single._resident() is not None
    assert_same(ranks[1]["state"], ranks[0]["state"], "trainer")
    for k, v in avg.items():
        if k != "seconds":
            np.testing.assert_allclose(ranks[0]["avg"][k], v, rtol=1e-4, err_msg=k)
    for m in ("g", "d"):
        for k, v in buffers(child._snapshot(state)[m]).items():
            assert (ranks[0]["state"][m][k] - v).abs().max().item() <= 1e-4 * v.abs().max().item(), (m, k)
    # Rank 0 writes the metrics and the checkpoint; rank 1 writes nothing.
    assert (tmp_path / "mesh" / "rank0" / "losses" / "metrics.csv").exists()
    assert os.listdir(tmp_path / "mesh" / "rank0" / cfg.train.checkpoint_dir) == ["step_00000002"]
    assert not (tmp_path / "mesh" / "rank1").exists()


# ---------------------------------------------------------------------------
# One process: the helpers without a process group
# ---------------------------------------------------------------------------


def test_one_process_mesh_and_collectives():
    m = TM.make_mesh("cpu")
    assert (m.axis_names, m.shape, m.rank, m.size, m.groups, m.world_group) == (("data",), (1,), 0, 1, (None,), None)
    assert m.batch_slice(4) == slice(0, 4)
    grid = TM.make_mesh_grid(1, 1, device="cpu")
    assert grid.axis_names == ("data", "samples") and grid.axis_size("samples") == 1
    with pytest.raises(ValueError, match="needs 4 ranks"):
        TM.make_mesh_grid(2, 2, device="cpu")
    with pytest.raises(ValueError, match="not 'tensor'"):
        m.axis_size("tensor")
    x = torch.arange(6.0, requires_grad=True)
    assert TM.all_sum(x, None) is x and TM.all_mean(x, None) is x and TM.all_min(x, None) is x
    assert TM.all_gather_cat(x, None) is x and TM.group_size(None) == 1
    x.grad = torch.ones(6)
    TM.average_gradients([x], None)
    assert torch.equal(x.grad, torch.ones(6))
    if not torch.cuda.is_available():  # like every entry point, no silent CPU fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.make_mesh()


def test_one_process_distributed_helpers(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize() is None
    assert distributed.local_batch_slice(6) == slice(0, 6)
    assert distributed.rank_device(1, 2, "cpu") == torch.device("cpu")
    assert distributed.choose_backend(torch.device("cpu"), 2) == "gloo"
    with pytest.raises(ValueError, match="init_file"):
        distributed.spawn(child.k5, 2, "cpu", join=False)
    with pytest.raises(ValueError, match="2-D"):
        TT.make_grid_parallel_step(tiny(TC.preset_target_lighting_train()), TM.make_mesh("cpu"))


def test_a_rank_that_raises_fails_the_spawn(tmp_path):
    with pytest.raises(Exception, match="batch 3 does not split evenly"):
        distributed.spawn(child.trainer_epoch, 2, "cpu", str(tmp_path / "rdzv"),
                          args=(str(tmp_path), "bad", (2,), tiny(TC.preset_target_lighting_train(), batch=3),
                                str(tmp_path / "w"), 0))

"""Rank workers for the port's multi-process CPU tests (imported by tests/test_torch_parallel.py
and tests/test_torch_sp_march.py; no JAX here).

Each worker runs in a process that `parallel.distributed.spawn` started, as
one rank of a gloo group on the CPU, and writes what it computed to
`<out_dir>/<tag>_rank<r>.pt`, where the test reads it back. Inputs arrive as
numpy arrays and picklable configs.
"""

import os

import numpy as np
import torch

from chip_smoke import CollectiveCounter
from geomconsistentfr_torch import train as TT
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.models.layers import BatchNorm
from geomconsistentfr_torch.ops import cuda_lib, shadows, shadows_cuda
from geomconsistentfr_torch.parallel import mesh as M


def _setup() -> int:
    """One warmed-up intra-op thread (tests/torch_cpu_threads.py says why); this rank."""
    torch.set_num_threads(1)
    x = torch.full((1 << 23,), 3.3)
    torch.exp(x)
    torch.sqrt(x)
    return torch.distributed.get_rank()


def _save(out_dir, tag, rank, **values):
    torch.save(values, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))


def _shard(ts_global: np.ndarray, m: M.Mesh, axis: str) -> torch.Tensor:
    n = m.axis_size(axis)
    return torch.from_numpy(ts_global.reshape(n, -1)[m.axis_index(axis)].copy())


def k5(device, out_dir, tag, cfg, depth, mask, lights, cot):
    """K5 on this rank's slice of sharded_sample_ts over a 1-D mesh of the world (its launches and
    its collectives counted, forward and backward), the winner t* it combines, and the serving
    combine."""
    rank = _setup()
    m = M.make_mesh(device)
    ts_local = _shard(shadows.sharded_sample_ts(cfg, m.size), m, "data").to(device)
    depth, mask, lights, cot = (torch.from_numpy(a).to(device) for a in (depth, mask, lights, cot))
    d, lp = depth.clone().requires_grad_(), lights.clone().requires_grad_()
    before = dict(cuda_lib.LAUNCHES)
    with CollectiveCounter() as collectives:
        out = shadows_cuda.RayMarchMinDistanceSP.apply(d, mask, lp, cfg, ts_local, m.world_group)
        (out * cot).sum().backward()
    launches = {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()}
    ts_key, clamp = shadows_cuda._grid_slice(device, cfg, ts_local)
    key, _ = shadows_cuda._march_key(depth, mask, lights, ts_key, cfg, clamp=clamp)
    _, t_star = shadows_cuda._combine(key, m.world_group)
    served, served_t = shadows_cuda.sharded_march(depth, mask, lights, cfg, ts_local, m.world_group,
                                                  return_argmin_t=True)
    served_min = shadows_cuda.sharded_march(depth, mask, lights, cfg, ts_local, m.world_group)
    _save(out_dir, tag, rank, out=out.detach(), d_depth=d.grad, d_light=lp.grad, t_star=t_star,
          served=served, served_t=served_t, served_min=served_min, launches=launches,
          collectives=collectives.calls, collective_bytes=collectives.nbytes)


def batchnorm(device, out_dir, tag, x, cot, momentum):
    """BatchNorm over a group of the world on this rank's half of x, and the gradients averaged over it."""
    rank = _setup()
    m = M.make_mesh(device)
    part = m.batch_slice(x.shape[0])
    bn = BatchNorm(x.shape[1], momentum=momentum)
    xr = torch.from_numpy(x[part].copy()).requires_grad_()
    y = bn(xr, group=m.group("data"))
    M.all_sum((y * torch.from_numpy(cot[part])).sum(), m.group("data")).backward()
    M.average_gradients(list(bn.parameters()), m.world_group)
    _save(out_dir, tag, rank, y=y.detach(), x_grad=xr.grad, running_mean=bn.running_mean,
          running_var=bn.running_var, weight_grad=bn.weight.grad, bias_grad=bn.bias.grad)


def _mesh(device, shape):
    return M.make_mesh(device) if len(shape) == 1 else M.make_mesh_grid(*shape, device=device)


def relighter(device, out_dir, tag, jobs, cfgs, state, images, masks, lights, ambients, sweep):
    """Relighter(mesh, parallel) for each (parallel, mesh shape) of `jobs` at each config:
    forward, forward_visuals, the sweeps and estimate_lighting (on 3 images unless 'data')."""
    rank = _setup()
    results = {}
    for parallel, shape in jobs:
        m = _mesh(device, shape)
        for name, cfg in cfgs.items():
            rl = Relighter(cfg, state, mesh=m, parallel=parallel)
            out = rl.forward(images, masks, lights, ambients)
            results[parallel, name] = dict(
                forward=out._asdict(),
                visuals=rl.forward_visuals(images, masks, lights, ambients),
                sweep=rl.relight_sweep(images[0], masks[0], sweep).rendered,
                sweep_u8=rl.relight_sweep_rendered_u8(images[0], masks[0], sweep),
                lighting=rl.estimate_lighting(images if parallel == "data" else images[:3]),
            )
    _save(out_dir, tag, rank, results=results)


def _load(state: TT.TrainState, start: dict) -> None:
    state.g.load_state_dict(start["g"])
    state.d.load_state_dict(start["d"])


def _snapshot(state: TT.TrainState) -> dict:
    """Copies of the parameters, buffers, Adam moments and gradients (the step updates them in place)."""
    g_mu, g_nu = TT.adam_moments(state.opt_g, state.g)
    d_mu, d_nu = TT.adam_moments(state.opt_d, state.d)
    snap = dict(g=state.g.state_dict(), d=state.d.state_dict(), g_mu=g_mu, g_nu=g_nu, d_mu=d_mu, d_nu=d_nu,
                grads={f"{k}.{n}": p.grad for k, mod in (("g", state.g), ("d", state.d))
                       for n, p in mod.named_parameters()})
    return {k: {n: t.detach().clone() for n, t in v.items()} for k, v in snap.items()}


def train_steps(device, out_dir, tag, shapes, cfg, start, batches, use_skips):
    """For each mesh shape, the data-parallel (1-D) or grid (2-D) step over `batches` from the state `start`."""
    rank = _setup()
    results = {}
    for shape in shapes:
        m = _mesh(device, shape)
        step = TT.make_grid_parallel_step(cfg, m) if len(shape) == 2 else TT.make_data_parallel_step(cfg, m)
        state = TT.init_state(cfg, device)
        _load(state, start)
        part = m.batch_slice(cfg.train.batch_size)
        losses, states = [], []
        before = dict(cuda_lib.LAUNCHES)
        for b in batches:
            local = TT.decode_batch({k: v[part] for k, v in b.items()}, device)
            losses.append({k: float(v) for k, v in step(state, local, use_skips=use_skips).items()})
            states.append(_snapshot(state))
        results[shape] = dict(losses=losses, states=states,
                              launches={k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()})
    _save(out_dir, tag, rank, results=results)


def trainer_epoch(device, out_dir, tag, shape, cfg, workdir, seed):
    """Trainer(mesh=...).run_epoch on SyntheticFaceData in <workdir>/rank<r>, then a step checkpoint."""
    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData

    rank = _setup()
    m = _mesh(device, shape)
    trainer = TT.Trainer(cfg, SyntheticFaceData(num_samples=8, size=cfg.render.img_height),
                         workdir=os.path.join(workdir, f"rank{rank}"), mesh=m)
    state = trainer.init_or_resume(torch.Generator().manual_seed(seed))
    state, avg = trainer.run_epoch(state, 0)
    trainer.save(state)
    _save(out_dir, tag, rank, avg=avg, state=_snapshot(state), streams=trainer._resident() is None)


def trainer_epochs(device, out_dir, tag, cfg, workdir, epochs, num_samples):
    """`cli train`'s loop in a spawned rank: Trainer(mesh=the world) from
    init_or_resume() (weights seeded by cfg.train.seed), `epochs` epochs."""
    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData

    rank = _setup()
    trainer = TT.Trainer(cfg, SyntheticFaceData(num_samples=num_samples, size=cfg.render.img_height),
                         workdir=os.path.join(workdir, f"rank{rank}"), mesh=M.make_mesh(device))
    state = trainer.init_or_resume()
    rows = []
    for epoch in range(epochs):
        state, avg = trainer.run_epoch(state, epoch)
        rows.append(avg)
    _save(out_dir, tag, rank, epochs=rows)

"""Self-supervised GAN training (reference train_*.py:560-693).

Port of geomconsistentfr_tpu/train.py: `_train_step` (:180-288), the
data-parallel and grid steps (:303-410), and the `Trainer`'s epoch loop,
checkpoints and resume (:418-665). Semantics kept:
  * one RelightNet train-mode forward and one `render` per step serve both
    the discriminator and the generator phase (:618, :641);
  * the discriminator loss sees a detached composite; the generator's
    adversarial term runs the discriminator with its parameters held out of
    the gradient; the discriminator's BatchNorm statistics update over three
    train-mode forwards in the reference's order: fake, real, fake-for-G;
  * one backward of g_total + d_loss; the discriminator's Adam step (and so
    its moments) apply only when step % gd_ratio == 0, the generator's every
    step (:624-629);
  * the skip-connection gates come from `ModelConfig.skip_gates(epoch)`;
  * lighting is self-estimated, z clamped >= 0 (:357-360).
In training the march needs a gradient, so `render` runs the differentiable
march K4 (ops/shadows_cuda.RayMarchMinDistance): kernel K2 forward and
march_grad backward on the card, their plain versions on the CPU.

Several ranks (parallel/mesh.py), each a process of torch.distributed:
  * `make_data_parallel_step`: each rank steps on its slice of the global
    batch. The masked-loss sums, the loss means and the BatchNorm moments
    are reduced over the data group inside the graph, differentiably, as the
    JAX step psums them; the gradients are then averaged over every rank.
    The result is the single-device step on the global batch.
  * `make_grid_parallel_step`: a (data x samples) mesh. The data axis shards
    the batch as above; the samples axis shards the march's t grid: the
    march is K5 (ops/shadows_cuda.RayMarchMinDistanceSP) on this rank's slice
    of `sharded_sample_ts`, combined over the samples group by one MIN of
    packed (distance, t) keys, with its backward at the global winner's t.
    Everything else runs replicated along
    the samples axis.
The gradients are averaged over the whole world, not the data group alone:
march_grad's atomics (and some cuDNN backward algorithms) add in no fixed
order, so two sample replicas' gradients can differ in their last bits,
and only a mean over every rank gives every rank the same bits. Parameters,
BatchNorm statistics and Adam's moments therefore stay bit-identical on all
ranks. The ranks of a samples group replicate everything outside the march,
so the grid step runs cuDNN's deterministic algorithms: the replicas'
forwards, and so their statistics and losses, are then the same bits.

With compute_dtype 'float32' the whole step -- forwards, backward and both
optimizer steps -- runs with TF32 off: cuDNN would otherwise compute the
float32 convolutions' gradients in TF32, which the JAX package's float32
path never does.

PyTorch updates in place where JAX returns new values: `train_step` mutates
the `TrainState` (its modules, optimizers and step counter). Entry points run
on CUDA unless the caller passes device='cpu', and raise without a card.

The `Trainer` (JAX :418-782) also keeps the training set on the device
(`DeviceResidentBatches`, cfg.train.data_residency), traces its epochs
(`profile`, utils/profiling.trace) and renders a fixed probe every so often
(`visualize`).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from geomconsistentfr_torch.config import PipelineConfig, preset_target_lighting_train
from geomconsistentfr_torch.infer import resolve_device
from geomconsistentfr_torch.losses import discriminator_losses, generator_losses, masked_composite
from geomconsistentfr_torch.models.layers import deterministic_convs, no_tf32
from geomconsistentfr_torch.models.patchgan import PatchGAN
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.ops import shadows
from geomconsistentfr_torch.ops.shadows_cuda import RayMarchMinDistanceSP
from geomconsistentfr_torch.parallel.mesh import Mesh, average_gradients
from geomconsistentfr_torch.render import render
from geomconsistentfr_torch.utils import checkpoint as ckpt
from geomconsistentfr_torch.utils import profiling


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """torch.optim.Adam with the reference's settings (train_*.py:589-590)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class TrainState:
    """The generator and discriminator, their Adam optimizers and the step count."""

    def __init__(self, g: RelightNet, d: PatchGAN, opt_g, opt_d, step: int = 0):
        self.g, self.d, self.opt_g, self.opt_d, self.step = g, d, opt_g, opt_d, step

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "g": self.g.state_dict(),
            "d": self.d.state_dict(),
            "opt_g": self.opt_g.state_dict(),
            "opt_d": self.opt_d.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.g.load_state_dict(state["g"])
        self.d.load_state_dict(state["d"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])


def init_state(cfg: PipelineConfig, device=None, generator: Optional[torch.Generator] = None) -> TrainState:
    """Fresh G and D (torch-default init, G drawn first, then D) and fresh Adams.

    The weights come from `generator`, by default one seeded with
    cfg.train.seed; they are drawn on the CPU, so a seed gives the same
    weights on any device.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    g = RelightNet(cfg.model, device=device, generator=generator).train()
    d = PatchGAN(device=device, generator=generator).train()
    lr = cfg.train.learning_rate
    return TrainState(g, d, make_optimizer(g.parameters(), lr), make_optimizer(d.parameters(), lr))


def adam_moments(optimizer: torch.optim.Adam, module: torch.nn.Module):
    """(exp_avg, exp_avg_sq) by parameter name; parameters not stepped yet are left out."""
    mu, nu = {}, {}
    for name, p in module.named_parameters():
        st = optimizer.state.get(p)
        if st:
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
    return mu, nu


def decode_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch -> float32 tensors on `device`; uint8 fields are divided by 255 there.

    The cache serves uint8 images and masks (data/celebahq.py FIELDS), which
    move 2.8x fewer bytes; the division equals CelebAHQRelightingData.get_batch's
    host-side `.astype(np.float32) / 255.0`. Float fields pass through.
    """
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(device)
        out[k] = t.float() / 255.0 if t.dtype == torch.uint8 else t.float()
    return out


class DeviceResidentBatches:
    """The whole training set on the device; a batch is a gather there (JAX train.py:131-178).

    The provider's stored bytes (uint8 where the cache stores uint8, float32
    elsewhere) go to the device once. A step then moves only its int32
    indices, and `index_select` and `decode_batch` run on the device: the
    same division of the same bytes as streaming's decode_batch, so the
    batches are bit-equal to the streamed ones.
    """

    def __init__(self, dataset: Dict[str, torch.Tensor]):
        self.dataset = dataset
        self.device = next(iter(dataset.values())).device

    @staticmethod
    def build(data, budget_mb: int, device) -> Optional["DeviceResidentBatches"]:
        """Upload `data`'s whole store, or None when the provider has no whole-set
        access (get_batch_raw or get_batch, and num_samples) or its bytes exceed
        `budget_mb` MiB."""
        get = getattr(data, "get_batch_raw", None) or getattr(data, "get_batch", None)
        n = getattr(data, "num_samples", None)
        if get is None or n is None:
            return None
        per_sample = sum(v.nbytes for v in get(np.arange(min(int(n), 1))).values())
        if per_sample * int(n) > budget_mb * (1 << 20):
            return None
        host = get(np.arange(int(n)))
        return DeviceResidentBatches({k: torch.as_tensor(np.ascontiguousarray(v)).to(device) for k, v in host.items()})

    def get(self, indices: np.ndarray) -> Dict[str, torch.Tensor]:
        idx = torch.as_tensor(np.ascontiguousarray(indices, np.int32)).to(self.device, non_blocking=True)
        return decode_batch({k: v.index_select(0, idx) for k, v in self.dataset.items()}, self.device)


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    cfg: PipelineConfig,
    use_skips: Tuple[bool, bool, bool, bool],
    mesh: Optional[Mesh] = None,
    march_fn=None,
) -> Dict[str, torch.Tensor]:
    """One GAN step on a decoded batch; updates `state` in place, returns the losses.

    The returned dict holds the generator's terms and total and the
    discriminator's terms as detached 0-d tensors on the state's device.
    With a `mesh`, `batch` is this rank's slice of the global batch: the
    losses and BatchNorm moments reduce over the mesh's first (data) axis
    and the gradients are averaged over all its ranks (the module docstring
    says why). `march_fn` replaces the render's march (render.render).
    """
    precision = no_tf32() if cfg.model.compute_dtype == "float32" else contextlib.nullcontext()
    # Ranks that share a batch slice (a samples axis) must compute the same
    # bits outside the march, or their BatchNorm statistics and losses part.
    replicated = mesh is not None and mesh.size > mesh.axis_size(mesh.axis_names[0])
    with precision, deterministic_convs() if replicated else contextlib.nullcontext():
        return _train_step(state, batch, cfg, tuple(use_skips), mesh, march_fn)


def _train_step(state: TrainState, batch, cfg: PipelineConfig, use_skips, mesh, march_fn) -> Dict[str, torch.Tensor]:
    g, d = state.g.train(), state.d.train()
    lcfg = cfg.train.loss
    images, face_mask = batch["image"], batch["face_mask"]
    group = mesh.group(mesh.axis_names[0]) if mesh is not None else None

    net = g(images, use_skips, group)
    out = render(net.albedo, net.depth, net.lighting, face_mask, cfg.render, march_fn=march_fn)
    composite = masked_composite(out.rendered, images, face_mask)

    # D's BatchNorm statistics update over three forwards, in reference order.
    fake_sg = d(composite.detach(), group)
    real_sg = d(images, group)
    d_metrics = discriminator_losses(fake_sg, real_sg, lcfg, group)
    frozen = {name: p.detach() for name, p in d.named_parameters()}
    fake_for_g = functional_call(d, frozen, (composite,), {"group": group})

    g_metrics = generator_losses(
        rendered=out.rendered,
        images=images,
        depth=out.depth,
        depth_gt=batch["depth_gt"],
        depth_mask=batch["depth_mask"],
        albedo=out.albedo,
        albedo_gt=batch["albedo_gt"],
        face_mask=face_mask,
        est_ambient=out.ambient_values,
        est_unit_dir=out.unit_light_direction,
        light_gt=batch["light_gt"],
        fake_logits=fake_for_g,
        cfg=lcfg,
        group=group,
    )
    state.opt_g.zero_grad(set_to_none=True)
    state.opt_d.zero_grad(set_to_none=True)
    (g_metrics["total"] + d_metrics["discriminator"]).backward()
    # A parameter outside this step's graph (a skip branch whose gate is
    # closed) gets a zero gradient, as jax.grad gives it: Adam then counts the
    # step and decays its moments, as optax does, instead of skipping it.
    for p in itertools.chain(g.parameters(), d.parameters()):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        average_gradients(list(itertools.chain(g.parameters(), d.parameters())), mesh.world_group)
    # D's parameters and moments update only every gd_ratio-th step; its
    # BatchNorm statistics and its loss every step (reference :624-629).
    if state.step % cfg.train.gd_ratio == 0:
        state.opt_d.step()
    state.opt_g.step()
    state.step += 1
    return {k: v.detach() for k, v in {**g_metrics, **d_metrics}.items()}


def make_data_parallel_step(cfg: PipelineConfig, mesh: Mesh):
    """step(state, batch, use_skips): train_step on this rank's slice of a batch sharded over the mesh."""
    return functools.partial(train_step, cfg=cfg, mesh=mesh)


def make_grid_parallel_step(cfg: PipelineConfig, mesh: Mesh):
    """step(state, batch, use_skips) on a 2-D (data, samples) mesh.

    The batch shards over the data axis as in make_data_parallel_step; the
    march is K5 on this rank's contiguous slice of
    sharded_sample_ts(cfg.render, n_samples), combined over the samples
    group. Batch 3 caps plain data parallelism at 3 ranks; the samples axis
    goes on sharding the march's 160 samples at a fixed batch.
    """
    if len(mesh.axis_names) != 2:
        raise ValueError("the grid step needs a 2-D (data, samples) mesh; see parallel.mesh.make_mesh_grid")
    samples_axis = mesh.axis_names[1]
    n_s, shard = mesh.axis_size(samples_axis), mesh.axis_index(samples_axis)
    ts = shadows.sharded_sample_ts(cfg.render, n_s).reshape(n_s, -1)[shard]
    ts_local = torch.as_tensor(ts, device=mesh.device)
    group = mesh.group(samples_axis)

    def march(depth, mask, light_point):
        return RayMarchMinDistanceSP.apply(depth, mask, light_point, cfg.render, ts_local, group)

    return functools.partial(train_step, cfg=cfg, mesh=mesh, march_fn=march)


# ---------------------------------------------------------------------------
# Trainer driver
# ---------------------------------------------------------------------------

# A scalar fetch every this many steps bounds how far the host runs ahead of
# the device and surfaces NaNs and errors near their step.
_SYNC_EVERY = 8

# "Not decided yet" for the Trainer's residency (None means: stream).
_UNSET = object()


class Trainer:
    """Epoch loop: batch order, GD alternation, metrics, checkpoints, resume.

    `data` provides numpy batches (data/celebahq.py). With a `mesh` every
    rank runs the same loop on its device (mesh.device): it draws the same
    global batch, takes its slice over the mesh's data axis, and steps with
    the grid step on a 2-D mesh or the data-parallel step on a 1-D mesh of
    several ranks; only rank 0 writes checkpoints and metrics.

    cfg.train.data_residency: 'stream' uploads each step's batch; 'device'
    keeps the whole set on the device (DeviceResidentBatches) and raises
    where a provider has no whole-set access or a set is above
    cfg.train.device_data_budget_mb; 'auto' is 'device' where it can be,
    else 'stream'. A mesh of several ranks streams under every setting, as
    the JAX package's Trainer does (each rank would hold the whole set to
    use a slice of each batch). With `profile` every epoch
    runs inside utils.profiling.trace into <workdir>/profile.
    """

    def __init__(
        self,
        cfg: Optional[PipelineConfig] = None,
        data=None,
        workdir: str = "runs/train",
        device=None,
        mesh: Optional[Mesh] = None,
        profile: bool = False,
    ):
        self.cfg = cfg or preset_target_lighting_train()
        residency = self.cfg.train.data_residency
        if residency not in ("auto", "device", "stream"):
            raise ValueError(f"data_residency must be 'auto', 'device' or 'stream', not {residency!r}")
        self.profile = profile
        self._resident_cache = _UNSET
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.data = data
        self.workdir = workdir
        if mesh is not None and len(mesh.axis_names) == 2:
            self.step_fn = make_grid_parallel_step(self.cfg, mesh)
        elif mesh is not None and mesh.size > 1:
            self.step_fn = make_data_parallel_step(self.cfg, mesh)
        else:
            self.step_fn = functools.partial(train_step, cfg=self.cfg)
        self.metrics_log: list = []

    @property
    def writes(self) -> bool:
        """True on the rank that writes checkpoints and metrics (rank 0, or the only process)."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def checkpoint_root(self) -> str:
        return os.path.join(self.workdir, self.cfg.train.checkpoint_dir)

    def init_or_resume(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """The newest step checkpoint under the workdir, else a fresh state."""
        state = init_state(self.cfg, self.device, generator)
        latest = ckpt.latest_step_dir(self.checkpoint_root)
        if latest is not None:
            state.load_state_dict(ckpt.load_train_state(latest, map_location=self.device))
        return state

    def save(self, state: TrainState) -> str:
        """Write a step checkpoint (on the writing rank only); its path."""
        path = os.path.join(self.checkpoint_root, f"step_{state.step:08d}")
        if self.writes:
            ckpt.save_train_state(path, state.state_dict())
            ckpt.prune_step_dirs(self.checkpoint_root, self.cfg.train.keep_checkpoints)
        return path

    def _resident(self) -> Optional[DeviceResidentBatches]:
        """The device-resident batch source, built at first call, or None to stream
        (the class docstring says when)."""
        tcfg = self.cfg.train
        if tcfg.data_residency == "stream" or (self.mesh is not None and self.mesh.size > 1):
            return None
        if self._resident_cache is _UNSET:
            built = DeviceResidentBatches.build(self.data, tcfg.device_data_budget_mb, self.device)
            if built is None and tcfg.data_residency == "device":
                raise ValueError("data_residency='device' but the provider has no whole-set access or exceeds "
                                 f"device_data_budget_mb={tcfg.device_data_budget_mb}")
            self._resident_cache = built
        return self._resident_cache

    def _batches(self, rng: np.random.Generator, start_batch: int):
        """The epoch's batches on the device (this rank's slice of each):
        shuffled contiguous slots where the data has them, else i.i.d. index
        draws (gathered on the device when the set is resident), else i.i.d.
        batch draws."""
        tcfg = self.cfg.train
        part = self.mesh.batch_slice(tcfg.batch_size) if self.mesh is not None else slice(None)
        get_batch = getattr(self.data, "get_batch_raw", None) or getattr(self.data, "get_batch", None)
        if hasattr(self.data, "epoch_batch_indices"):
            index_iter = self.data.epoch_batch_indices(rng, tcfg.batch_size, tcfg.batches_per_epoch)
        elif hasattr(self.data, "sample_indices") and get_batch is not None:
            index_iter = (self.data.sample_indices(rng, tcfg.batch_size) for _ in range(tcfg.batches_per_epoch))
        else:
            sample_batch = getattr(self.data, "sample_batch_raw", self.data.sample_batch)
            batches = (sample_batch(rng, tcfg.batch_size) for _ in range(tcfg.batches_per_epoch))
            # Draw and discard: the resumed stream equals the uninterrupted one.
            return (decode_batch({k: v[part] for k, v in b.items()}, self.device)
                    for b in itertools.islice(batches, start_batch, None))
        # Fast-forward at the index level (no IO); each rank reads only its slice.
        index_iter = itertools.islice(index_iter, start_batch, None)
        resident = self._resident()
        if resident is not None:
            return map(resident.get, index_iter)
        return (decode_batch(get_batch(idx[part]), self.device) for idx in index_iter)

    def run_epoch(
        self,
        state: TrainState,
        epoch: int,
        rng: Optional[np.random.Generator] = None,
        start_batch: int = 0,
    ):
        """One epoch of cfg.train.batches_per_epoch batches (:606-607) -> (state, mean losses).

        The batch order derives from (seed, epoch), so a run resumed at an
        epoch replays the batches an uninterrupted run would have seen;
        `rng` overrides it. `start_batch` resumes inside an epoch from a
        step-level checkpoint: the epoch's first `start_batch` batches are
        skipped, never trained.
        """
        tcfg = self.cfg.train
        if rng is None:
            rng = np.random.default_rng([tcfg.seed, epoch])
        use_skips = self.cfg.model.skip_gates(epoch)
        t0 = time.time()
        pending: list = []
        tracing = profiling.trace(os.path.join(self.workdir, "profile")) if self.profile else contextlib.nullcontext()
        with tracing:
            for j, batch in enumerate(self._batches(rng, start_batch)):
                pos = start_batch + j + 1  # 1-based position within the epoch
                metrics = self.step_fn(state, batch, use_skips=use_skips)
                if pos % tcfg.log_every_steps == 0:
                    pending.append(metrics)
                if (pos - start_batch) % _SYNC_EVERY == 0:
                    float(metrics["total"])
                # Step-level checkpoints (the reference saves per epoch and cannot resume).
                if (tcfg.checkpoint_every_steps and pos % tcfg.checkpoint_every_steps == 0
                        and pos < tcfg.batches_per_epoch):
                    self.save(state)
        sums: Dict[str, float] = {}
        if pending:
            keys = list(pending[0])
            rows = torch.stack([torch.stack([m[k] for k in keys]) for m in pending]).cpu().tolist()
            for row in rows:
                for k, v in zip(keys, row):
                    sums[k] = sums.get(k, 0.0) + v
        avg = {k: v / max(len(pending), 1) for k, v in sums.items()}
        avg["epoch"] = epoch
        avg["seconds"] = time.time() - t0
        self.metrics_log.append(avg)
        self._export_metrics(epoch, avg)
        return state, avg

    def visualize(self, state: TrainState, epoch: int) -> str:
        """Render a fixed probe through the current generator; the gallery's path (JAX :667-762).

        The probe is the data's first draw from rng (seed, 7123), one image,
        the same for every epoch. The generator runs in eval mode with the
        epoch's skip gates and renders under the probe's own light; input,
        albedo, depth (utils/io.depth_visualization: near is bright), shadow
        weights and the rendered face go to <workdir>/visuals/epoch_XXXX/
        as PNGs, and <workdir>/visuals/index.html gets a row (with the last
        epoch's mean total loss). A resumed run rebuilds the earlier rows
        from the epoch directories on disk. Only the writing rank writes.
        """
        from geomconsistentfr_torch.metrics.perceptual import write_html_gallery
        from geomconsistentfr_torch.utils.io import depth_visualization, write_image

        vis_root = os.path.join(self.workdir, "visuals")
        if not hasattr(self, "_vis_probe"):
            probe = self.data.sample_batch(np.random.default_rng([self.cfg.train.seed, 7123]), 1)
            # Stored-dtype sources expand on the host here, as get_batch does.
            self._vis_probe = {k: v.astype(np.float32) / 255.0 if v.dtype == np.uint8 else v for k, v in probe.items()}
            self._vis_rows = []
            if os.path.isdir(vis_root):
                for name in sorted(os.listdir(vis_root)):
                    if name.startswith("epoch_"):
                        row = {"epoch": int(name.split("_")[1])}
                        for kind in ("input", "albedo", "depth", "shadow", "rendered"):
                            path = os.path.join(vis_root, name, f"{kind}.png")
                            if os.path.exists(path):
                                row[kind] = path
                        self._vis_rows.append(row)
        probe = self._vis_probe
        tensors = {k: torch.as_tensor(np.asarray(probe[k], np.float32)).to(self.device)
                   for k in ("image", "face_mask", "light_gt")}
        precision = no_tf32() if self.cfg.model.compute_dtype == "float32" else contextlib.nullcontext()
        was_training = state.g.training
        state.g.eval()
        try:
            with torch.no_grad(), precision, deterministic_convs():
                net = state.g(tensors["image"], self.cfg.model.skip_gates(epoch))
                out = render(net.albedo, net.depth, net.lighting, tensors["face_mask"], self.cfg.render,
                             target_light=tensors["light_gt"])
        finally:
            state.g.train(was_training)
        if not self.writes:
            return os.path.join(vis_root, "index.html")
        vis_dir = os.path.join(vis_root, f"epoch_{epoch:04d}")
        row = {"epoch": epoch}

        def put(kind, arr01):
            row[kind] = os.path.join(vis_dir, f"{kind}.png")
            write_image(row[kind], np.asarray(arr01))

        host = {k: getattr(out, k)[0].cpu().numpy() for k in ("albedo", "depth", "shadow_mask_weights", "rendered")}
        put("input", probe["image"][0])
        put("albedo", host["albedo"])
        put("depth", depth_visualization(host["depth"], np.asarray(probe["face_mask"][0])))
        put("shadow", host["shadow_mask_weights"])
        put("rendered", host["rendered"])
        if self.metrics_log:
            row["total_loss"] = round(self.metrics_log[-1].get("total", 0.0), 4)
        self._vis_rows.append(row)
        index = os.path.join(vis_root, "index.html")
        write_html_gallery(index, self._vis_rows, title="training progress")
        return index

    def _export_metrics(self, epoch: int, avg: Dict[str, float]) -> None:
        """CSV and the reference-compatible .mat export (train_*.py:671-683), on the writing rank."""
        if not self.writes:
            return
        out_dir = os.path.join(self.workdir, "losses")
        os.makedirs(out_dir, exist_ok=True)
        csv_path = os.path.join(out_dir, "metrics.csv")
        write_header = not os.path.exists(csv_path)
        keys = sorted(avg)
        with open(csv_path, "a") as f:
            if write_header:
                f.write(",".join(keys) + "\n")
            f.write(",".join(str(avg[k]) for k in keys) + "\n")
        try:
            import scipy.io
        except ImportError:
            return
        scipy.io.savemat(os.path.join(out_dir, f"losses_epoch{epoch}.mat"), dict(avg))

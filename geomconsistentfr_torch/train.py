"""Self-supervised GAN training on one device (reference train_*.py:560-693).

Port of geomconsistentfr_tpu/train.py (`_train_step`, :180-288, and the
`Trainer`'s epoch loop, checkpoints and resume, :418-665) without its
multi-device paths. Semantics kept:
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

With compute_dtype 'float32' the whole step -- forwards, backward and both
optimizer steps -- runs with TF32 off: cuDNN would otherwise compute the
float32 convolutions' gradients in TF32, which the JAX package's float32
path never does.

PyTorch updates in place where JAX returns new values: `train_step` mutates
the `TrainState` (its modules, optimizers and step counter). Entry points run
on CUDA unless the caller passes device='cpu', and raise without a card.
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
from geomconsistentfr_torch.models.layers import no_tf32
from geomconsistentfr_torch.models.patchgan import PatchGAN
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.render import render
from geomconsistentfr_torch.utils import checkpoint as ckpt


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


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    cfg: PipelineConfig,
    use_skips: Tuple[bool, bool, bool, bool],
) -> Dict[str, torch.Tensor]:
    """One GAN step on a decoded batch; updates `state` in place, returns the losses.

    The returned dict holds the generator's terms and total and the
    discriminator's terms as detached 0-d tensors on the state's device.
    """
    precision = no_tf32() if cfg.model.compute_dtype == "float32" else contextlib.nullcontext()
    with precision:
        return _train_step(state, batch, cfg, tuple(use_skips))


def _train_step(state: TrainState, batch, cfg: PipelineConfig, use_skips) -> Dict[str, torch.Tensor]:
    g, d = state.g.train(), state.d.train()
    lcfg = cfg.train.loss
    images, face_mask = batch["image"], batch["face_mask"]

    net = g(images, use_skips)
    out = render(net.albedo, net.depth, net.lighting, face_mask, cfg.render)
    composite = masked_composite(out.rendered, images, face_mask)

    # D's BatchNorm statistics update over three forwards, in reference order.
    fake_sg = d(composite.detach())
    real_sg = d(images)
    d_metrics = discriminator_losses(fake_sg, real_sg, lcfg)
    frozen = {name: p.detach() for name, p in d.named_parameters()}
    fake_for_g = functional_call(d, frozen, (composite,))

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
    # D's parameters and moments update only every gd_ratio-th step; its
    # BatchNorm statistics and its loss every step (reference :624-629).
    if state.step % cfg.train.gd_ratio == 0:
        state.opt_d.step()
    state.opt_g.step()
    state.step += 1
    return {k: v.detach() for k, v in {**g_metrics, **d_metrics}.items()}


# ---------------------------------------------------------------------------
# Trainer driver
# ---------------------------------------------------------------------------

# A scalar fetch every this many steps bounds how far the host runs ahead of
# the device and surfaces NaNs and errors near their step.
_SYNC_EVERY = 8


class Trainer:
    """Epoch loop on one device: batch order, GD alternation, metrics, checkpoints, resume.

    `data` provides numpy batches (data/celebahq.py). Not ported yet (see
    ROADMAP): data_residency='device', profile traces, the visualizer and
    the data-parallel and grid steps; data_residency 'auto' streams.
    """

    def __init__(
        self,
        cfg: Optional[PipelineConfig] = None,
        data=None,
        workdir: str = "runs/train",
        device=None,
    ):
        self.cfg = cfg or preset_target_lighting_train()
        if self.cfg.train.data_residency == "device":
            raise NotImplementedError("data_residency='device' is not ported yet; use 'auto' or 'stream'")
        self.device = resolve_device(device)
        self.data = data
        self.workdir = workdir
        self.step_fn = functools.partial(train_step, cfg=self.cfg)
        self.metrics_log: list = []

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
        path = os.path.join(self.checkpoint_root, f"step_{state.step:08d}")
        ckpt.save_train_state(path, state.state_dict())
        ckpt.prune_step_dirs(self.checkpoint_root, self.cfg.train.keep_checkpoints)
        return path

    def _batches(self, rng: np.random.Generator, start_batch: int):
        """The epoch's host batches: shuffled contiguous slots where the data
        has them, else i.i.d. index draws, else i.i.d. batch draws."""
        tcfg = self.cfg.train
        get_batch = getattr(self.data, "get_batch_raw", None) or getattr(self.data, "get_batch", None)
        if hasattr(self.data, "epoch_batch_indices"):
            index_iter = self.data.epoch_batch_indices(rng, tcfg.batch_size, tcfg.batches_per_epoch)
        elif hasattr(self.data, "sample_indices") and get_batch is not None:
            index_iter = (self.data.sample_indices(rng, tcfg.batch_size) for _ in range(tcfg.batches_per_epoch))
        else:
            sample_batch = getattr(self.data, "sample_batch_raw", self.data.sample_batch)
            batches = (sample_batch(rng, tcfg.batch_size) for _ in range(tcfg.batches_per_epoch))
            # Draw and discard: the resumed stream equals the uninterrupted one.
            return itertools.islice(batches, start_batch, None)
        # Fast-forward at the index level (no IO).
        return map(get_batch, itertools.islice(index_iter, start_batch, None))

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
        for j, host_batch in enumerate(self._batches(rng, start_batch)):
            pos = start_batch + j + 1  # 1-based position within the epoch
            metrics = self.step_fn(state, decode_batch(host_batch, self.device), use_skips=use_skips)
            if pos % tcfg.log_every_steps == 0:
                pending.append(metrics)
            if (pos - start_batch) % _SYNC_EVERY == 0:
                float(metrics["total"])
            # Step-level checkpoints (the reference saves per epoch and cannot resume).
            if tcfg.checkpoint_every_steps and pos % tcfg.checkpoint_every_steps == 0 and pos < tcfg.batches_per_epoch:
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

    def _export_metrics(self, epoch: int, avg: Dict[str, float]) -> None:
        """CSV and the reference-compatible .mat export (train_*.py:671-683)."""
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

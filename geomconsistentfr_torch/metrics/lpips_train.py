"""The 2AFC training of LPIPS's linear heads (port of geomconsistentfr_tpu/metrics/lpips_train.py).

The vendored library's training mode (PerceptualSimilarity/lpips/
trainer.py:1-280): a Dist2Logit ranking net maps a distance pair (d0, d1)
to the predicted human judgement; a BCE ranking loss trains it together
with the LPIPS heads, the trunk frozen (the reference's pnet_tune=False);
Adam (lr, beta1 0.5, beta2 0.999), the arithmetic of optax's adam that the
JAX package uses (train.make_optimizer's torch.optim.Adam); the heads
clamped to >= 0 after every step (trainer.py:105-108 clamp_weights).

  * Dist2Logit (lpips.py:169-184): 1x1 convs 5 -> 32 -> 32 -> 1, LeakyReLU
    0.2, a sigmoid, fed (d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)),
    eps 0.1;
  * bce_ranking_loss (lpips.py:186-196): BCE of the probability against the
    human fraction preferring p1;
  * compute_accuracy (trainer.py:138-142): (d1 < d0) * judge + (1 - (d1 <
    d0)) * (1 - judge).
Scoring (2AFC, JND) is metrics/perceptual.py's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geomconsistentfr_torch.models.layers import exact_convs, reset_torch_default
from geomconsistentfr_torch.models.lpips import LPIPS


class Dist2Logit(nn.Module):
    """A distance pair -> the probability that humans prefer p1 (lpips.py:169-184)."""

    def __init__(self, chn_mid: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = nn.Conv2d(5, chn_mid, 1)
        self.fc1 = nn.Conv2d(chn_mid, chn_mid, 1)
        self.fc2 = nn.Conv2d(chn_mid, 1, 1)
        reset_torch_default(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, d0: torch.Tensor, d1: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
        feats = torch.stack([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)], dim=1)[:, :, None, None]
        x = F.leaky_relu(self.fc0(feats), 0.2)
        x = F.leaky_relu(self.fc1(x), 0.2)
        return torch.sigmoid(self.fc2(x))[:, 0, 0, 0]


def bce_ranking_loss(prob: torch.Tensor, judge: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """BCELoss(prob, judge), judge the human fraction preferring p1."""
    prob = torch.clamp(prob, eps, 1.0 - eps)
    return -torch.mean(judge * torch.log(prob) + (1.0 - judge) * torch.log(1.0 - prob))


def compute_accuracy(d0: torch.Tensor, d1: torch.Tensor, judge: torch.Tensor) -> torch.Tensor:
    """The share of the human judgements the metric agrees with (trainer.py:138-142)."""
    d1_lt_d0 = (d1 < d0).to(judge.dtype)
    return torch.mean(d1_lt_d0 * judge + (1.0 - d1_lt_d0) * (1.0 - judge))


class LPIPS2AFCTrainer:
    """Trains LPIPS's heads and the ranking net on 2AFC triples; the trunk stays frozen.

    Batches are dicts of float arrays in [0, 1]: ref, p0, p1 (B, H, W, 3) and
    judge (B,), the human fraction preferring p1. The heads and ranking net
    start from torch's default init drawn from `seed` (the modules `lpips`
    and `ranknet` take other weights with load_state_dict). Runs on CUDA
    unless `device` says otherwise, in float32 without TF32 and with cuDNN's
    deterministic algorithms.
    """

    def __init__(self, trunk_state: Optional[Dict] = None, allow_random_trunk: bool = False, lr: float = 1e-4,
                 beta1: float = 0.5, seed: int = 0, net: str = "alex", device=None):
        from geomconsistentfr_torch.infer import resolve_device

        if trunk_state is None and not allow_random_trunk:
            raise RuntimeError(f"LPIPS2AFCTrainer needs {net} trunk weights; pass trunk_state= or "
                               "allow_random_trunk=True (a smoke run)")
        self.net, self.lr = net, lr
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        self.lpips = LPIPS(net, spatial=False, generator=generator)
        if trunk_state is not None:
            self.lpips.trunk.load_state_dict({k: torch.as_tensor(v) for k, v in trunk_state.items()})
        self.lpips.to(self.device).eval()
        self.lpips.trunk.requires_grad_(False)
        self.ranknet = Dist2Logit(generator=generator).to(self.device)
        self.params = [p for lin in self.lpips.lins for p in lin.parameters()] + list(self.ranknet.parameters())
        self.optimizer = torch.optim.Adam(self.params, lr=lr, betas=(beta1, 0.999), eps=1e-8)

    def decay_learning_rate(self, nepoch_decay: int) -> float:
        """trainer.py:189-197: lr -= initial lr / nepoch_decay a call; the moments stay."""
        lr = self.optimizer.param_groups[0]["lr"] - self.lr / nepoch_decay
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device) for k, v in batch.items()}

    def _distances(self, b: Dict[str, torch.Tensor]):
        d0 = self.lpips(b["ref"] * 2.0 - 1.0, b["p0"] * 2.0 - 1.0)
        d1 = self.lpips(b["ref"] * 2.0 - 1.0, b["p1"] * 2.0 - 1.0)
        return d0, d1

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        b = self._tensors(batch)
        with exact_convs():
            d0, d1 = self._distances(b)
            loss = bce_ranking_loss(self.ranknet(d0, d1), b["judge"])
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            with torch.no_grad():
                for lin in self.lpips.lins:  # clamp_weights
                    lin.model[1].weight.clamp_(min=0.0)
                acc = compute_accuracy(d0, d1, b["judge"])
        return {"loss_total": float(loss.detach()), "acc_r": float(acc)}

    def evaluate(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        b = self._tensors(batch)
        with exact_convs(), torch.no_grad():
            d0, d1 = self._distances(b)
            return {"acc_r": float(compute_accuracy(d0, d1, b["judge"])), "d0_mean": float(d0.mean()),
                    "d1_mean": float(d1.mean())}

    def lin_state(self) -> Dict[str, np.ndarray]:
        """The heads in the library's layout: {'lin{i}.model.1.weight': (1, C, 1, 1)}."""
        return {f"lin{i}.model.1.weight": lin.model[1].weight.detach().cpu().numpy().astype(np.float32)
                for i, lin in enumerate(self.lpips.lins)}

    def save_lin_weights(self, path: str) -> None:
        """The heads as the library's bundled files have them: `.npz` (numpy) or else a torch file;
        both load with models.lpips.load_lin_weights."""
        state = self.lin_state()
        if path.endswith(".npz"):
            np.savez(path, **state)
            return
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)

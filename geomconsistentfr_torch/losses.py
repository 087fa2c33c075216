"""Training losses (reference train_raytracing_relighting_CelebAHQ_DSSIM_8x.py:582-645).

Port of geomconsistentfr_tpu/losses.py:29-150. Seven generator terms and
the discriminator term, with the reference's weights and mask normalisations:
  reconstruction  20 * sum((rend - img)^2 * mask3) / sum(mask3)      (:633)
  depth            sum(|depth - gt| * mask) / sum(mask)              (:634)
  ambient          2.5 * mean(|ambient_est - 0.5|)                   (:635)
  direction        sum(1 - <unit_est, unit_gt>) / B                  (:636)
  albedo           5 * sum(|gray(albedo) - gt| * mask) / sum(mask)   (:637-639)
  g_adv            0.01 * BCE(D(composite), real)                    (:641-642)
  dssim            8 * (1 - SSIM(composite, img)) / 2                (:643)
  d_loss           0.01 * (BCE(D(composite), fake) + BCE(D(img), real)) (:621-623)
where composite = rendered*mask3 + (1-mask3)*img (:619).

With a process `group` (the ranks that share the batch; JAX's `axis_name`),
the masked sums are summed and the means averaged over it
(parallel.mesh.all_sum / all_mean, differentiable), so a sharded batch gives
the global batch's normalisation exactly.
"""

from __future__ import annotations

from typing import Dict

import torch

from geomconsistentfr_torch.config import LossConfig
from geomconsistentfr_torch.ops.ssim import ssim
from geomconsistentfr_torch.parallel.mesh import all_mean, all_sum


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """Mean binary cross-entropy on logits (torch BCEWithLogitsLoss's formula), averaged over `group`."""
    return all_mean(torch.mean(
        torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    ), group)


def masked_composite(rendered: torch.Tensor, image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rendered*mask + (1-mask)*image with a (B, H, W) mask over (B, H, W, 3)."""
    m = mask[..., None]
    return rendered * m + (1.0 - m) * image


def generator_losses(
    *,
    rendered: torch.Tensor,      # (B, H, W, 3)
    images: torch.Tensor,        # (B, H, W, 3) input photos (self-supervision target)
    depth: torch.Tensor,         # (B, H, W) predicted
    depth_gt: torch.Tensor,      # (B, H, W) pseudo-GT
    depth_mask: torch.Tensor,    # (B, H, W) depth-loss mask
    albedo: torch.Tensor,        # (B, H, W, 3) predicted
    albedo_gt: torch.Tensor,     # (B, H, W) grayscale pseudo-GT
    face_mask: torch.Tensor,     # (B, H, W) "fill nose and mouth" mask
    est_ambient: torch.Tensor,   # (B,)
    est_unit_dir: torch.Tensor,  # (B, 3)
    light_gt: torch.Tensor,      # (B, 3)
    fake_logits: torch.Tensor,   # D(composite)
    cfg: LossConfig,
    group=None,
) -> Dict[str, torch.Tensor]:
    """The generator's terms and their weighted total, as scalars (the group's, with a group)."""

    def allsum(x):
        return all_sum(torch.sum(x), group)

    def allmean(x):
        return all_mean(torch.mean(x), group)

    composite = masked_composite(rendered, images, face_mask)
    recon = cfg.reconstruction * allsum(torch.square(rendered - images) * face_mask[..., None]) / (
        3.0 * allsum(face_mask)
    )
    depth_l = cfg.depth * allsum(torch.abs(depth - depth_gt) * depth_mask) / allsum(depth_mask)
    ambient_l = cfg.ambient * allmean(torch.abs(est_ambient - cfg.ambient_target))
    direction_l = cfg.direction * allmean(1.0 - torch.sum(est_unit_dir * light_gt, dim=-1))
    gray_albedo = torch.mean(albedo, dim=-1)
    albedo_l = cfg.albedo * allsum(torch.abs(gray_albedo - albedo_gt) * face_mask) / allsum(face_mask)
    g_adv = cfg.gan * bce_with_logits(fake_logits, torch.ones_like(fake_logits), group)
    dssim_l = cfg.dssim * (1.0 - all_mean(ssim(composite, images, data_range=1.0, nonnegative=True), group)) / 2.0

    total = recon + depth_l + ambient_l + direction_l + albedo_l + g_adv + dssim_l
    return {
        "total": total,
        "reconstruction": recon,
        "depth": depth_l,
        "ambient": ambient_l,
        "direction": direction_l,
        "albedo": albedo_l,
        "generator": g_adv,
        "dssim": dssim_l,
    }


def discriminator_losses(
    fake_logits: torch.Tensor, real_logits: torch.Tensor, cfg: LossConfig, group=None
) -> Dict[str, torch.Tensor]:
    d_fake = cfg.gan * bce_with_logits(fake_logits, torch.zeros_like(fake_logits), group)
    d_real = cfg.gan * bce_with_logits(real_logits, torch.ones_like(real_logits), group)
    return {
        "discriminator": d_fake + d_real,
        "discriminator_fake": d_fake,
        "discriminator_real": d_real,
    }


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean(torch.square(x - y))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))

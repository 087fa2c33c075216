"""The GAN training step of GeomConsistentFR in plain PyTorch, float32.

A frozen statement of `train_raytracing_relighting_CelebAHQ_DSSIM_8x.py`
(lines 560-693): one RelightNet forward in train mode and one render under
the self-estimated light; the composite rendered * mask + (1 - mask) * image;
the discriminator on the detached composite and on the photo; the
generator's seven terms (reconstruction 20, depth 1, ambient 2.5 toward 0.5,
direction 1, grey albedo 5, adversarial 0.01, DSSIM 8 from pytorch_msssim's
SSIM with an 11-tap gaussian of sigma 1.5, non-negative); one backward of the
generator's total plus the discriminator's loss, the generator's adversarial
term seeing the discriminator's parameters as constants; then Adam (betas
0.9, 0.999, eps 1e-8) on the discriminator every `gd_ratio`-th step and on
the generator every step. A parameter outside the step's graph gets a zero
gradient, so Adam still counts the step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from gcfr_bench.reference.render import render


def bce(logits, target):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def ssim(x, y):
    """Mean SSIM of (B, H, W, C) images in [0, 1], per channel made non-negative."""
    b, h, w, c = x.shape
    g = np.exp(-((np.arange(11) - 5.0) ** 2) / (2 * 1.5 ** 2))
    win = torch.as_tensor((g / g.sum()).astype(np.float32), device=x.device).to(x.dtype)

    def blur(a):
        return F.conv2d(F.conv2d(a, win.view(1, 1, 11, 1)), win.view(1, 1, 1, 11))

    x = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    y = y.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = blur(x), blur(y)
    sxx = blur(x * x) - mx * mx
    syy = blur(y * y) - my * my
    sxy = blur(x * y) - mx * my
    s = ((2 * mx * my + c1) / (mx * mx + my * my + c1)) * ((2 * sxy + c2) / (sxx + syy + c2))
    return torch.relu(s.mean(dim=(1, 2, 3)).view(b, c)).mean()


def step(g, d, opt_g, opt_d, step_index, batch, rcfg, loss, gd_ratio, use_skips):
    """One step on a batch of float32 tensors; returns its losses as floats."""
    img, mask = batch["image"], batch["face_mask"]
    albedo, depth, lighting = g(img, use_skips)
    out = render(albedo, depth, lighting, mask, rcfg)
    m3 = mask[..., None]
    comp = out["rendered"] * m3 + (1.0 - m3) * img
    fake, real = d(comp.detach()), d(img)
    d_loss = loss["gan"] * (bce(fake, 0.0) + bce(real, 1.0))
    frozen = {k: v.detach() for k, v in d.named_parameters()}
    fake_g = functional_call(d, frozen, (comp,))
    recon = loss["reconstruction"] * torch.sum(torch.square(out["rendered"] - img) * m3) / (3.0 * mask.sum())
    depth_l = loss["depth"] * torch.sum(torch.abs(depth - batch["depth_gt"]) * batch["depth_mask"]) \
        / batch["depth_mask"].sum()
    amb_l = loss["ambient"] * torch.mean(torch.abs(out["ambient"] - loss["ambient_target"]))
    dir_l = loss["direction"] * torch.mean(1.0 - torch.sum(out["unit_light"] * batch["light_gt"], dim=-1))
    alb_l = loss["albedo"] * torch.sum(torch.abs(albedo.mean(-1) - batch["albedo_gt"]) * mask) / mask.sum()
    adv = loss["gan"] * bce(fake_g, 1.0)
    dssim = loss["dssim"] * (1.0 - ssim(comp, img)) / 2.0
    total = recon + depth_l + amb_l + dir_l + alb_l + adv + dssim
    opt_g.zero_grad(set_to_none=True)
    opt_d.zero_grad(set_to_none=True)
    (total + d_loss).backward()
    for p in list(g.parameters()) + list(d.parameters()):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if step_index % gd_ratio == 0:
        opt_d.step()
    opt_g.step()
    return {"total": float(total.detach()), "discriminator": float(d_loss.detach())}


def adam(params, lr):
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=False)

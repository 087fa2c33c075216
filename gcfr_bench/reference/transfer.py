"""Lighting transfer in plain PyTorch, float32: GeomConsistentFR's two passes
(`test_relight_single_image_lighting_transfer.py`).

The first pass runs the transfer RelightNet on the reference face and keeps
only its lighting head: the light's unit direction from (head[:, 1],
head[:, 2], z) with z = max(head[:, 3], z_clamp_min), and the ambient
head[:, 0]. The second runs it on the input face and renders the input under
that light and ambient (the config's `ambient_mode` 'target'). Images are
(B, H, W, 3) in [0, 1], masks (B, H, W) in [0, 1]; `rcfg` is the config
file's `render` group, a dict.
"""

from __future__ import annotations

import torch

from gcfr_bench.reference.render import normalize, render, visual_pack


def estimated_light(lighting, rcfg):
    """The head's raw (B, 4) -> (unit direction (B, 3), ambient (B,))."""
    z = torch.clamp(lighting[:, 3], min=rcfg["z_clamp_min"])
    return normalize(torch.stack([lighting[:, 1], lighting[:, 2], z], dim=-1)), lighting[:, 0]


def transfer_pack(net, images, masks, references, rcfg):
    """The uint8 (B, H, W, 12) visuals of `images` relit under the light that `net`
    estimates from `references`."""
    light, ambient = estimated_light(net(references)[2], rcfg)
    albedo, depth, lighting = net(images)
    out = render(albedo, depth, lighting, masks, rcfg, target_light=light, target_ambient=ambient)
    return visual_pack(albedo, depth, out, masks)

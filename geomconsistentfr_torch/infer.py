"""Inference: batched relighting, light sweeps, lighting transfer (one device).

Port of geomconsistentfr_tpu/infer.py:48-551 without the multi-device paths:
  * `Relighter.forward`           -- batched relighting with explicit targets.
  * `Relighter.forward_visuals`   -- the same, packed into uint8 visuals.
  * `Relighter.relight_sweep`     -- one network forward, the renderer over L lights.
  * `Relighter.estimate_lighting` / `transfer_lighting` -- the 2-pass protocol.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
card and no explicit CPU request they raise. Inputs may be numpy arrays or
tensors: images (B, H, W, 3) and masks (B, H, W), float32 in [0, 1] or uint8
(divided by 255 on the device). Outputs are tensors on the Relighter's device.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from geomconsistentfr_torch.config import PipelineConfig, preset_lighting_transfer
from geomconsistentfr_torch.convert import is_transfer_state, load_checkpoint, transfer_to_target_variant
from geomconsistentfr_torch.models.relightnet import FULL_SKIPS, RelightNet
from geomconsistentfr_torch.render import RenderOutputs, estimated_light, render

# Channel layout of the packed uint8 visualization tensor (B, H, W, 12).
VISUAL_PACK_LAYOUT = (
    ("rendered_image", 3),
    ("shadow_mask", 1),
    ("albedo", 3),
    ("depth", 1),
    ("shading", 1),
    ("surface_normals", 3),
)


def resolve_device(device=None) -> torch.device:
    """`device`, or `cuda` when none is given; raises when CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def _to_unit(q: torch.Tensor) -> torch.Tensor:
    """floor(clip(x * 255)) as uint8 (numpy's float->uint8 truncation)."""
    return torch.floor(torch.clamp(q * 255.0, 0.0, 255.0)).to(torch.uint8)


def pack_visuals(outputs: RenderOutputs, masks: torch.Tensor) -> torch.Tensor:
    """The six eval visualizations fused into one uint8 (B, H, W, 12) tensor."""
    m1 = masks[..., None]
    d = -outputs.depth
    dmin = d.amin(dim=(1, 2), keepdim=True)
    dmax = d.amax(dim=(1, 2), keepdim=True)
    depth_vis = (d - dmin) / torch.clamp(dmax - dmin, min=1e-12)
    packed = torch.cat(
        [
            outputs.rendered * m1,
            (outputs.shadow_mask_weights * masks)[..., None],
            outputs.albedo * m1,
            (depth_vis * masks)[..., None],
            (outputs.final_shading * masks)[..., None],
            (outputs.surface_normals + 1.0) / 2.0 * m1,
        ],
        dim=-1,
    )
    return _to_unit(packed)


class Relighter:
    """RelightNet + the renderer on one device."""

    def __init__(
        self,
        cfg: PipelineConfig,
        state_dict,
        use_skips: Tuple[bool, bool, bool, bool] = FULL_SKIPS,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_skips = tuple(use_skips)
        self.model = RelightNet(cfg.model, device=self.device)
        self.model.load_state_dict(state_dict)
        self.model.eval()

    def _as_input(self, x) -> torch.Tensor:
        """Tensor on the device; uint8 is divided by 255 there, else float32."""
        x = torch.as_tensor(x)
        if x.dtype == torch.uint8:
            return x.to(self.device).float() / 255.0
        return x.to(self.device, torch.float32)

    def _targets(self, b, target_light, target_ambient):
        if target_light is None:
            target_light = torch.zeros((b, 3))
        if target_ambient is None:
            target_ambient = torch.zeros((b,))
        return (
            torch.as_tensor(target_light).to(self.device, torch.float32),
            torch.as_tensor(target_ambient).to(self.device, torch.float32),
        )

    @torch.no_grad()
    def forward(self, images, masks, target_light=None, target_ambient=None) -> RenderOutputs:
        """Relight a batch: images (B, H, W, 3), masks (B, H, W), target_light (B, 3)."""
        images, masks = self._as_input(images), self._as_input(masks)
        light, ambient = self._targets(images.shape[0], target_light, target_ambient)
        net = self.model(images, self.use_skips)
        return render(net.albedo, net.depth, net.lighting, masks, self.cfg.render,
                      target_light=light, target_ambient=ambient)

    @torch.no_grad()
    def forward_visuals(self, images, masks, target_light=None, target_ambient=None) -> torch.Tensor:
        """`forward`, returned as the packed uint8 (B, H, W, 12) visuals."""
        out = self.forward(images, masks, target_light, target_ambient)
        return pack_visuals(out, self._as_input(masks))

    @torch.no_grad()
    def relight_sweep(self, image, mask, lights, ambients=None) -> RenderOutputs:
        """One image (H, W, 3), L target lights (L, 3) -> outputs with leading axis L."""
        lights = torch.as_tensor(lights).to(self.device, torch.float32)
        n = lights.shape[0]
        if ambients is None:
            ambients = torch.full((n,), 0.5)
        ambients = torch.as_tensor(ambients).to(self.device, torch.float32)
        image, mask = self._as_input(image), self._as_input(mask)
        net = self.model(image[None], self.use_skips)

        def tile(x):
            return x.expand(n, *x.shape[1:])

        return render(tile(net.albedo), tile(net.depth), tile(net.lighting),
                      mask[None].expand(n, *mask.shape), self.cfg.render,
                      target_light=lights, target_ambient=ambients)

    @torch.no_grad()
    def relight_sweep_rendered_u8(self, image, mask, lights, ambients=None) -> torch.Tensor:
        """Sweep returning only the masked uint8 renders (L, H, W, 3)."""
        out = self.relight_sweep(image, mask, lights, ambients)
        return _to_unit(out.rendered * self._as_input(mask)[None, ..., None])

    @torch.no_grad()
    def estimate_lighting(self, images):
        """Estimated (unit direction (B, 3), ambient (B,)), z clamped per the config."""
        net = self.model(self._as_input(images), self.use_skips)
        return estimated_light(net.lighting, self.cfg.render)

    def transfer_lighting(self, input_images, reference_images, masks) -> RenderOutputs:
        """2-pass lighting transfer: estimate from `reference`, render `input`."""
        unit, ambient = self.estimate_lighting(reference_images)
        return self.forward(input_images, masks, target_light=unit, target_ambient=ambient)


def load_relighter(
    checkpoint_path: str,
    cfg: Optional[PipelineConfig] = None,
    use_skips: Tuple[bool, bool, bool, bool] = FULL_SKIPS,
    device=None,
) -> Relighter:
    """Build a Relighter from a reference `.pth` state dict.

    Transfer-variant weights embed exactly into the target variant, so a
    'target' config takes a transfer checkpoint as it is.
    """
    if cfg is None:
        cfg = preset_lighting_transfer()
    if os.path.isdir(checkpoint_path):
        raise NotImplementedError(
            "orbax checkpoint directories are not supported by the PyTorch port; "
            "pass a reference .pth state dict"
        )
    state = load_checkpoint(checkpoint_path)
    if cfg.model.variant == "target" and is_transfer_state(state):
        state = transfer_to_target_variant(state)
    return Relighter(cfg, state, use_skips=use_skips, device=device)

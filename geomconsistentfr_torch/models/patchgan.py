"""PatchGAN discriminator (reference train_*.py:15-35), PyTorch.

Port of geomconsistentfr_tpu/models/patchgan.py. Five 4x4 convolutions with
padding 1: stride 2 for conv1-4 (3 -> 64 -> 128 -> 256 -> 512, BatchNorm on
conv2-4, LeakyReLU 0.2), stride 1 for conv5 -> (B, 15, 15, 1) patch logits on
a 256x256 input. The submodules carry the flax names (conv1..conv5,
bn2..bn4), so `convert.state_dict_from_jax_variables` carries flax PatchGAN
variables across unchanged. Images in and logits out are NHWC, as in the JAX
package; NCHW inside. Torch-default init from an explicit generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geomconsistentfr_torch.config import PatchGANConfig
from geomconsistentfr_torch.models.layers import BatchNorm, leaky_relu, reset_torch_default


class PatchGAN(nn.Module):
    def __init__(
        self,
        cfg: PatchGANConfig = PatchGANConfig(),
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            cin = 3
            for i, feat in enumerate(cfg.channels, start=1):
                self.add_module(f"conv{i}", nn.Conv2d(cin, feat, cfg.kernel, stride=2, padding=1))
                if i > 1:
                    self.add_module(f"bn{i}", BatchNorm(feat, eps=cfg.bn_eps, momentum=cfg.bn_momentum))
                cin = feat
            self.add_module(f"conv{len(cfg.channels) + 1}", nn.Conv2d(cin, 1, cfg.kernel, stride=1, padding=1))
        self.to_empty(device=device or "cpu")
        reset_torch_default(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, img: torch.Tensor, group=None) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, H', W', 1) patch logits; train mode updates BN statistics.

        `group`: the process group whose ranks share the batch (cross-replica BatchNorm).
        """
        m = self._modules
        slope = self.cfg.leaky_slope
        x = leaky_relu(self.conv1(img.permute(0, 3, 1, 2)), slope)
        for i in range(2, len(self.cfg.channels) + 1):
            x = leaky_relu(m[f"bn{i}"](m[f"conv{i}"](x), group=group), slope)
        return m[f"conv{len(self.cfg.channels) + 1}"](x).permute(0, 2, 3, 1)

"""RelightNet: shared encoder + lighting head + albedo & depth decoders (PyTorch).

Port of geomconsistentfr_tpu/models/relightnet.py. Every submodule carries the
reference checkpoint's name (conv_*, deconv_*, bn_*, linear_SL*), so a
reference `.pth` state dict loads with `load_state_dict` as it is. The
decoders' layers are stride-1, padding-1 `nn.ConvTranspose2d`s with the
reference's (I, O, kh, kw) weights.

Variants differ only in the projection shortcuts: 'target' has 3x3 shortcuts
with bias, 'transfer' 1x1 without bias.

Precision follows the JAX model: with compute_dtype 'bfloat16' convs and
activations run in bfloat16, except the decoders' main-branch deconvs, which
the JAX model leaves without a dtype so that flax promotes them to float32;
BatchNorm is float32 with a narrowed output; the lighting head and the
outputs are float32.

Each convolution with a BatchNorm ends in one epilogue
(`layers.conv_bn_act`): its bias, the BatchNorm, the residual (a tensor or
a projection shortcut's conv and BatchNorm) and the LeakyReLU, and at a
decoder stage's end the upsample and the skip. In eval mode on the card in
float32 without autograd that is one launch of csrc/epilogue.cu, bit for
bit the eager composition that runs otherwise; and for the 16-channel 3x3
layers (the encoder's h1_1, h1_2; each decoder's skip_s3_*, skip_s4_*,
h7_2, h8_1, h8_2, c2_1: 18 a forward) one launch of csrc/conv3x3.cu does
the convolution too.

Public layout is the JAX package's: images (B, H, W, 3) in [0, 1]; outputs
albedo (B, H, W, 3), depth (B, H, W) (x100), lighting (B, 4). NCHW inside.
`estimate` runs the encoder and the lighting head alone (the lighting is
read from the encoder's last map; the decoders feed nothing into it), the
same code as `forward`'s first part, so its lighting is bit-equal.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from geomconsistentfr_torch.config import ModelConfig
from geomconsistentfr_torch.models.layers import (
    BatchNorm,
    Branch,
    conv,
    conv_bn_act,
    leaky_relu,
    max_pool2,
    no_tf32,
    reset_torch_default,
)
from geomconsistentfr_torch.utils.profiling import span

FULL_SKIPS = (True, True, True, True)

# (stage, width, shortcut source); the last stage keeps a plain residual.
_DECODER_STAGES = (
    ("h5", 64, "all_features"),
    ("h6", 32, "h5_out"),
    ("h7", 16, "h6_out"),
    ("h8", 16, None),
)


class RelightNetOutputs(NamedTuple):
    albedo: torch.Tensor      # (B, H, W, 3), sigmoid
    depth: torch.Tensor       # (B, H, W), scaled by 100
    lighting: torch.Tensor    # (B, 4) raw head output: [ambient, lx, ly, lz]


class RelightNet(nn.Module):
    def __init__(
        self,
        cfg: ModelConfig = ModelConfig(),
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cfg.variant not in ("target", "transfer"):
            raise ValueError(f"unknown variant: {cfg.variant}")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype: {cfg.compute_dtype}")
        self.cfg = cfg
        # Built on 'meta' and materialised on `device`, so construction
        # neither draws from the global RNG nor allocates twice.
        with torch.device("meta"):
            self._build()
        self.to_empty(device=device or "cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_torch_default(self, generator)

    def _conv_bn(self, name: str, cin: int, cout: int, k: int) -> None:
        self.add_module(f"conv_{name}", nn.Conv2d(cin, cout, k, padding=(k - 1) // 2))
        self.add_module(f"bn_{name}", BatchNorm(cout, eps=self.cfg.bn_eps, momentum=self.cfg.bn_momentum))

    def _shortcut(self, name: str, cin: int, cout: int, transposed: bool) -> None:
        layer = nn.ConvTranspose2d if transposed else nn.Conv2d
        prefix = "deconv_" if transposed else "conv_"
        if self.cfg.variant == "target":
            module = layer(cin, cout, 3, padding=1)
        else:
            module = layer(cin, cout, 1, padding=0, bias=False)
        self.add_module(f"{prefix}{name}", module)
        self.add_module(f"bn_{name}", BatchNorm(cout, eps=self.cfg.bn_eps, momentum=self.cfg.bn_momentum))

    def _build(self) -> None:
        cfg = self.cfg
        bc = cfg.base_channels
        self._conv_bn("c1_og", cfg.in_channels, bc, 5)
        self._conv_bn("h1_1", bc, 16, 3)
        self._conv_bn("h1_2", 16, 16, 3)
        for stage, cin, cout, src in (("h2", 16, 32, "h1_out"), ("h3", 32, 64, "h2_out"), ("h4", 64, 155, "h3_out")):
            self._conv_bn(f"{stage}_1", cin, cout, 3)
            self._conv_bn(f"{stage}_2", cout, cout, 3)
            self._shortcut(f"shortcut_{src}", cin, cout, transposed=False)
        self.add_module("linear_SL1", nn.Linear(cfg.lighting_channels, cfg.lighting_hidden))
        self.add_module("linear_SL2", nn.Linear(cfg.lighting_hidden, cfg.lighting_out))
        skip_channels = (64, 32, 16, bc)
        for prefix in ("albedo", "depth"):
            cin = cfg.identity_channels
            for idx, (stage, feat, src) in enumerate(_DECODER_STAGES):
                for i, ci in ((1, cin), (2, feat)):
                    self.add_module(f"deconv_{prefix}_{stage}_{i}", nn.ConvTranspose2d(ci, feat, 3, padding=1))
                    self.add_module(f"bn_{prefix}_{stage}_{i}", BatchNorm(feat, eps=cfg.bn_eps, momentum=cfg.bn_momentum))
                if src is not None:
                    self._shortcut(f"{prefix}_shortcut_{src}", cin, feat, transposed=True)
                c = skip_channels[idx]
                self._conv_bn(f"{prefix}_skip_s{idx + 1}_1", c, c, 3)
                self._conv_bn(f"{prefix}_skip_s{idx + 1}_2", c, c, 3)
                cin = feat
            self._conv_bn(f"{prefix}_c2_1", 16, 16, 3)
            self._conv_bn(f"{prefix}_c2_2", 16, 16, 1)
            self._conv_bn(f"{prefix}_c2_3", 16, 16, 1)
            self.add_module(f"conv_{prefix}_c2_o", nn.Conv2d(16, 3 if prefix == "albedo" else 1, 1))

    def forward(
        self,
        img: torch.Tensor,
        use_skips: Tuple[bool, bool, bool, bool] = FULL_SKIPS,
        group=None,
    ) -> RelightNetOutputs:
        """`group`: the process group whose ranks share the batch, for
        cross-replica BatchNorm in train mode (the JAX model's `axis_name`)."""
        with no_tf32():
            return self._forward(img, use_skips, group)

    def estimate(self, img: torch.Tensor) -> torch.Tensor:
        """The lighting head's output (B, 4) alone: the encoder and the head run,
        the decoders do not. Bit-equal to `forward(img).lighting`."""
        with no_tf32():
            return self._encode(img, None)[2]

    def _dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32

    def _branch(self, x, name, layer=None, conv_dtype=None) -> Branch:
        """conv `layer` (conv_<name> by default) with BatchNorm bn_<name>, on x."""
        m = self._modules
        return Branch(m[layer or f"conv_{name}"], m[f"bn_{name}"], x, conv_dtype or self._dtype())

    def _layer(self, main, residual=None, group=None, **join) -> torch.Tensor:
        """One epilogue: lrelu(residual + BN(conv)) (layers.conv_bn_act)."""
        return conv_bn_act(main, residual, self.cfg.leaky_slope, dtype=self._dtype(), group=group, **join)

    def _forward(self, img, use_skips, group) -> RelightNetOutputs:
        identity, skips, lighting = self._encode(img, group)
        with span("gcfr.cnn.decoder_albedo"):
            albedo = torch.sigmoid(self._decoder("albedo", identity, skips, use_skips, group)).permute(0, 2, 3, 1)
        with span("gcfr.cnn.decoder_depth"):
            depth = 100.0 * self._decoder("depth", identity, skips, use_skips, group)[:, 0]
        return RelightNetOutputs(albedo=albedo, depth=depth, lighting=lighting)

    def _encode(self, img, group):
        """The encoder and the lighting head: (h4_out's identity channels, the
        decoders' skip sources deepest first, lighting (B, 4))."""
        cfg = self.cfg
        layer, branch = functools.partial(self._layer, group=group), self._branch
        with span("gcfr.cnn.encoder"):
            x = img.permute(0, 3, 1, 2).to(self._dtype())
            c1_og = layer(branch(x, "c1_og"))
            c1 = max_pool2(c1_og)
            h1_1 = layer(branch(c1, "h1_1"))
            h1_out_og = layer(branch(h1_1, "h1_2"), c1)
            skips = [h1_out_og]
            h = h1_out_og
            for stage, src in (("h2", "h1_out"), ("h3", "h2_out"), ("h4", "h3_out")):
                h_in = max_pool2(h)
                y1 = layer(branch(h_in, f"{stage}_1"))
                h = layer(branch(y1, f"{stage}_2"), branch(h_in, f"shortcut_{src}"))
                skips.append(h)
            h4_out = skips.pop()
        identity = h4_out[:, : cfg.identity_channels]
        lighting_features = h4_out[:, cfg.identity_channels :]

        # Lighting head: f32 global average -> MLP.
        with span("gcfr.cnn.lighting_head"):
            lf = lighting_features.float().mean(dim=(2, 3))
            lighting = self.linear_SL2(leaky_relu(self.linear_SL1(lf), cfg.leaky_slope))
        return identity, (skips[2], skips[1], skips[0], c1_og), lighting

    def _decoder(self, prefix: str, identity, skips, use_skips, group) -> torch.Tensor:
        """Decoder `prefix` ('albedo' or 'depth') from the identity channels, before its output's activation."""
        layer, branch = functools.partial(self._layer, group=group), self._branch
        x = identity
        for idx, (stage, _feat, src) in enumerate(_DECODER_STAGES):
            # The skip branch first, always evaluated; the gate only adds it.
            s = skips[idx]
            s1 = layer(branch(s, f"{prefix}_skip_s{idx + 1}_1"))
            s_out = layer(branch(s1, f"{prefix}_skip_s{idx + 1}_2"), s)
            # Main-branch deconvs run in float32 (flax promotion in the
            # JAX model); their BatchNorm narrows back to the compute dtype.
            main = f"{prefix}_{stage}"
            y1 = layer(branch(x, f"{main}_1", f"deconv_{main}_1", torch.float32))
            sc = x if src is None else branch(x, f"{prefix}_shortcut_{src}", f"deconv_{prefix}_shortcut_{src}")
            # x = up2(lrelu(sc + y2)) [+ s_out]
            x = layer(branch(y1, f"{main}_2", f"deconv_{main}_2", torch.float32), sc, upsample=True,
                      skip=s_out if use_skips[idx] else None)
        x = layer(branch(x, f"{prefix}_c2_1"))
        x = layer(branch(x, f"{prefix}_c2_2"))
        x = layer(branch(x, f"{prefix}_c2_3"))
        return conv(self._modules[f"conv_{prefix}_c2_o"], x, self._dtype()).float()

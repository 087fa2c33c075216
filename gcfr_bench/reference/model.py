"""RelightNet and the PatchGAN discriminator in plain PyTorch, float32.

A frozen, independent statement of the two networks of GeomConsistentFR
(CVPR 2022; `train_raytracing_relighting_CelebAHQ_DSSIM_8x.py` and
`test_relight_single_image.py`): `nn.Conv2d`, `nn.ConvTranspose2d`,
`nn.BatchNorm2d` and `nn.Linear` under the reference checkpoint's names, so
one state dict loads into this module and into the program alike. Images are
(B, H, W, 3) in [0, 1]; RelightNet returns albedo (B, H, W, 3), depth
(B, H, W) scaled by 100 and the lighting head's raw (B, 4).

`variant` 'target' has 3x3 projection shortcuts with bias, 'transfer' 1x1
without. The callers set TF32 off (`reference.precision`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

SLOPE = 0.2
# (stage, width, shortcut source) of each decoder; the last stage has none.
DECODER = (("h5", 64, "all_features"), ("h6", 32, "h5_out"), ("h7", 16, "h6_out"), ("h8", 16, None))
ENCODER = (("h2", 16, 32, "h1_out"), ("h3", 32, 64, "h2_out"), ("h4", 64, 155, "h3_out"))
IDENTITY = 128


def lrelu(x):
    return F.leaky_relu(x, SLOPE)


class RelightNet(nn.Module):
    def __init__(self, variant: str = "target"):
        super().__init__()
        self.variant = variant
        self._cb("c1_og", 3, 16, 5)
        self._cb("h1_1", 16, 16, 3)
        self._cb("h1_2", 16, 16, 3)
        for stage, cin, cout, src in ENCODER:
            self._cb(f"{stage}_1", cin, cout, 3)
            self._cb(f"{stage}_2", cout, cout, 3)
            self._shortcut(f"shortcut_{src}", cin, cout, nn.Conv2d, "conv_")
        self.linear_SL1 = nn.Linear(27, 128)
        self.linear_SL2 = nn.Linear(128, 4)
        for p in ("albedo", "depth"):
            cin = IDENTITY
            for i, (stage, feat, src) in enumerate(DECODER):
                for j, c in ((1, cin), (2, feat)):
                    self.add_module(f"deconv_{p}_{stage}_{j}", nn.ConvTranspose2d(c, feat, 3, padding=1))
                    self.add_module(f"bn_{p}_{stage}_{j}", nn.BatchNorm2d(feat))
                if src is not None:
                    self._shortcut(f"{p}_shortcut_{src}", cin, feat, nn.ConvTranspose2d, "deconv_")
                c = (64, 32, 16, 16)[i]
                self._cb(f"{p}_skip_s{i + 1}_1", c, c, 3)
                self._cb(f"{p}_skip_s{i + 1}_2", c, c, 3)
                cin = feat
            self._cb(f"{p}_c2_1", 16, 16, 3)
            self._cb(f"{p}_c2_2", 16, 16, 1)
            self._cb(f"{p}_c2_3", 16, 16, 1)
            self.add_module(f"conv_{p}_c2_o", nn.Conv2d(16, 3 if p == "albedo" else 1, 1))

    def _cb(self, name, cin, cout, k):
        self.add_module(f"conv_{name}", nn.Conv2d(cin, cout, k, padding=k // 2))
        self.add_module(f"bn_{name}", nn.BatchNorm2d(cout))

    def _shortcut(self, name, cin, cout, layer, prefix):
        if self.variant == "target":
            self.add_module(prefix + name, layer(cin, cout, 3, padding=1))
        else:
            self.add_module(prefix + name, layer(cin, cout, 1, padding=0, bias=False))
        self.add_module(f"bn_{name}", nn.BatchNorm2d(cout))

    def _conv_bn(self, x, name, prefix="conv_"):
        return self._modules[f"bn_{name}"](self._modules[prefix + name](x))

    def forward(self, img, use_skips=(True, True, True, True)):
        cb = self._conv_bn
        x = img.permute(0, 3, 1, 2)
        c1_og = lrelu(cb(x, "c1_og"))
        c1 = F.max_pool2d(c1_og, 2)
        h = lrelu(c1 + cb(lrelu(cb(c1, "h1_1")), "h1_2"))
        skips = [h]
        for stage, _cin, _cout, src in ENCODER:
            h_in = F.max_pool2d(h, 2)
            y = cb(lrelu(cb(h_in, f"{stage}_1")), f"{stage}_2")
            h = lrelu(cb(h_in, f"shortcut_{src}") + y)
            skips.append(h)
        h4 = skips.pop()
        lighting = self.linear_SL2(lrelu(self.linear_SL1(h4[:, IDENTITY:].mean(dim=(2, 3)))))
        skips = (skips[2], skips[1], skips[0], c1_og)

        def decoder(p):
            x = h4[:, :IDENTITY]
            for i, (stage, _feat, src) in enumerate(DECODER):
                y = lrelu(cb(x, f"{p}_{stage}_1", "deconv_"))
                y = cb(y, f"{p}_{stage}_2", "deconv_")
                sc = x if src is None else cb(x, f"{p}_shortcut_{src}", "deconv_")
                x = F.interpolate(lrelu(sc + y), scale_factor=2, mode="nearest")
                s = skips[i]
                s_out = lrelu(s + cb(lrelu(cb(s, f"{p}_skip_s{i + 1}_1")), f"{p}_skip_s{i + 1}_2"))
                if use_skips[i]:
                    x = x + s_out
            for k in (1, 2, 3):
                x = lrelu(cb(x, f"{p}_c2_{k}"))
            return self._modules[f"conv_{p}_c2_o"](x)

        albedo = torch.sigmoid(decoder("albedo")).permute(0, 2, 3, 1)
        depth = 100.0 * decoder("depth")[:, 0]
        return albedo, depth, lighting


class PatchGAN(nn.Module):
    """Five 4x4 convolutions, padding 1; stride 2 for conv1-4, BatchNorm on conv2-4."""

    def __init__(self, channels=(64, 128, 256, 512)):
        super().__init__()
        cin = 3
        for i, c in enumerate(channels, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(cin, c, 4, stride=2, padding=1))
            if i > 1:
                self.add_module(f"bn{i}", nn.BatchNorm2d(c))
            cin = c
        self.n = len(channels)
        self.add_module(f"conv{self.n + 1}", nn.Conv2d(cin, 1, 4, stride=1, padding=1))

    def forward(self, img):
        m = self._modules
        x = lrelu(self.conv1(img.permute(0, 3, 1, 2)))
        for i in range(2, self.n + 1):
            x = lrelu(m[f"bn{i}"](m[f"conv{i}"](x)))
        return m[f"conv{self.n + 1}"](x).permute(0, 2, 3, 1)

"""LPIPS, the learned perceptual metric, with AlexNet, VGG16 and SqueezeNet trunks.

Port of geomconsistentfr_tpu/models/lpips.py (itself the vendored
PerceptualSimilarity library's lpips.py:22-241 and test_network.py:30-52):
  * inputs in [-1, 1], shifted and scaled by the ScalingLayer (shift
    [-.030, -.088, -.188], scale [.458, .448, .450], lpips.py:152-159);
  * a feature trunk tapped after the ReLUs of pretrained_networks.py's
    slices: alexnet 5 taps, vgg16 5 (relu1_2 ... relu5_3), squeezenet1_1 7
    (its pools in ceil mode);
  * each tap unit-normalised over its channels (eps 1e-10), the squared
    difference, a learned 1x1 linear head (no bias), then either upsampled
    bilinearly to the input's size (spatial) or averaged, summed over taps.

Each trunk is torchvision's `features` as a plain nn.Sequential with
torchvision's indices, so a torchvision state_dict (`features.N.weight`)
loads with `load_state_dict` and no conversion (`load_trunk_state`), and the
linear heads keep the library's `lin{i}.model.1.weight` keys
(`load_lin_weights`): a library `.pth` of heads loads as it is. The
convolutions are torch's (cuDNN on the card). Nothing is downloaded: without
trunk weights `LPIPSMetric` refuses unless told to use a random trunk.

The modules take and return NHWC, as the JAX package's do; inside they run
NCHW. On the card LPIPSMetric runs without TF32 and with cuDNN's
deterministic algorithms, so a map does not move between processes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geomconsistentfr_torch.models.layers import exact_convs, reset_torch_default

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def _alex_features() -> nn.Sequential:
    """torchvision alexnet().features (pools floor mode, 3x3 stride 2)."""
    return nn.Sequential(
        nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
        nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2),
    )


_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")


def _vgg16_features() -> nn.Sequential:
    """torchvision vgg16().features."""
    layers: List[nn.Module] = []
    c = 3
    for v in _VGG_CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(c, v, 3, padding=1), nn.ReLU()]
            c = v
    return nn.Sequential(*layers)


class Fire(nn.Module):
    """torchvision's SqueezeNet Fire module: squeeze 1x1, then 1x1 and 3x3 expands, concatenated."""

    def __init__(self, c_in: int, squeeze: int, e1: int, e3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(c_in, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, e1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, e3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


def _squeeze_features() -> nn.Sequential:
    """torchvision squeezenet1_1().features (pools 3x3 stride 2, ceil mode)."""
    return nn.Sequential(
        nn.Conv2d(3, 64, 3, stride=2), nn.ReLU(), nn.MaxPool2d(3, 2, ceil_mode=True),
        Fire(64, 16, 64, 64), Fire(128, 16, 64, 64), nn.MaxPool2d(3, 2, ceil_mode=True),
        Fire(128, 32, 128, 128), Fire(256, 32, 128, 128), nn.MaxPool2d(3, 2, ceil_mode=True),
        Fire(256, 48, 192, 192), Fire(384, 48, 192, 192), Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
    )


# Per trunk: its `features`, the indices after which pretrained_networks.py
# taps it, and the taps' channels.
TRUNKS = {
    "alex": (_alex_features, (1, 4, 7, 9, 11), (64, 192, 384, 256, 256)),
    "vgg": (_vgg16_features, (3, 8, 15, 22, 29), (64, 128, 256, 512, 512)),
    "squeeze": (_squeeze_features, (1, 4, 7, 9, 10, 11, 12), (64, 128, 256, 384, 384, 512, 512)),
}


class Trunk(nn.Module):
    """A torchvision `features` stack returning its LPIPS taps (NCHW): Trunk('alex'),
    Trunk('vgg') and Trunk('squeeze') are the JAX package's AlexFeatures,
    VGG16Features and SqueezeFeatures."""

    def __init__(self, net: str):
        super().__init__()
        make, self.taps, _ = TRUNKS[net]
        self.features = make()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                taps.append(x)
                if i == self.taps[-1]:
                    break
        return taps


class NetLinLayer(nn.Module):
    """The library's linear head: dropout (idle in eval) then a bias-free 1x1 conv to one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def normalize_channels(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x / (its L2 norm over channels + eps), NCHW."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Trunk taps -> normalise -> squared difference -> linear heads -> sum over taps.

    forward(x, y): (B, H, W, 3) each in [-1, 1] -> (B, H, W) when `spatial`,
    else (B,). The module stays in eval mode (the heads' dropout is idle).
    """

    def __init__(self, net: str = "alex", spatial: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if net not in TRUNKS:
            raise ValueError(f"unknown LPIPS net: {net!r} (want one of {sorted(TRUNKS)})")
        self.net, self.spatial = net, spatial
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)
        self.trunk = Trunk(net)
        for i, c in enumerate(TRUNKS[net][2]):
            self.add_module(f"lin{i}", NetLinLayer(c))
        reset_torch_default(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.eval()

    @property
    def lins(self) -> List[NetLinLayer]:
        return [getattr(self, f"lin{i}") for i in range(len(TRUNKS[self.net][2]))]

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        xy = torch.cat([x, y]).permute(0, 3, 1, 2)
        taps = self.trunk((xy - self.shift) / self.scale)
        total = None
        for tap, lin in zip(taps, self.lins):
            a, b = normalize_channels(tap).chunk(2)
            d = lin((a - b) ** 2)  # (B, 1, h', w')
            if self.spatial:
                d = F.interpolate(d, size=(h, w), mode="bilinear", align_corners=False)[:, 0]
            else:
                d = d.mean(dim=(1, 2, 3))
            total = d if total is None else total + d
        return total


def _load_arrays(path: str, weights_only: bool) -> Dict[str, torch.Tensor]:
    """A .npz, or a torch file (a state dict, possibly nested under 'state_dict'), as tensors."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    raw = torch.load(path, map_location="cpu", weights_only=weights_only)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: v.detach().cpu() for k, v in raw.items() if isinstance(v, torch.Tensor)}


def load_lin_weights(path: str) -> Dict[str, torch.Tensor]:
    """The linear heads of a library `.pth` (lpips/weights/v0.1/{alex,vgg,squeeze}.pth) or of an
    `.npz` from LPIPS2AFCTrainer.save_lin_weights: {'lin{i}.model.1.weight': (1, C, 1, 1)}, every
    head present (5 for alex and vgg, 7 for squeeze)."""
    state = _load_arrays(path, weights_only=True)
    out = {}
    i = 0
    while f"lin{i}.model.1.weight" in state:
        key = f"lin{i}.model.1.weight"
        out[key] = state[key].float()
        i += 1
    if not out:
        raise ValueError(f"no lin-head keys in {path}")
    return out


def _conv_prefixes(net: str) -> List[str]:
    trunk = Trunk(net)
    return [name for name, m in trunk.features.named_modules() if isinstance(m, nn.Conv2d)]


def load_trunk_state(path: str, net: str = "alex") -> Dict[str, torch.Tensor]:
    """A torchvision trunk state dict from .pth / .pt (any pickle, nested under
    'state_dict' or not) or .npz: its `features.*` tensors, checked complete."""
    state = {k: v for k, v in _load_arrays(path, weights_only=False).items() if k.startswith("features.")}
    missing = [f"features.{p}.{kind}" for p in _conv_prefixes(net) for kind in ("weight", "bias")
               if f"features.{p}.{kind}" not in state]
    if missing:
        raise ValueError(f"trunk state at {path} is missing keys: {missing}")
    return state


class LPIPSMetric:
    """The evaluation's callable: (gt01, pred01), (H, W, 3) in [0, 1] -> the (H, W) LPIPS map.

    `trunk_state` is a torchvision state dict (`load_trunk_state`),
    `lin_weights_path` a file of linear heads (`load_lin_weights`). Without a
    trunk it raises unless `allow_random_trunk` (a smoke run: torch's default
    init from seed 0, and random heads where no file is given). Runs on CUDA
    unless `device` says otherwise; raises without a card.
    """

    def __init__(self, lin_weights_path: Optional[str] = None, trunk_state: Optional[Dict] = None,
                 allow_random_trunk: bool = False, net: str = "alex", device=None):
        from geomconsistentfr_torch.infer import resolve_device

        if net not in TRUNKS:
            raise ValueError(f"unknown LPIPS net: {net!r} (want one of {sorted(TRUNKS)})")
        if trunk_state is None and not allow_random_trunk:
            raise RuntimeError(f"LPIPS needs {net} trunk weights (a torchvision state_dict); pass trunk_state= "
                               "or allow_random_trunk=True")
        if lin_weights_path is None and not allow_random_trunk:
            raise RuntimeError("LPIPS needs its linear heads (lpips/weights/v0.1/<net>.pth); pass lin_weights_path=")
        self.device = resolve_device(device)
        model = LPIPS(net, spatial=True)
        if trunk_state is not None:
            model.trunk.load_state_dict({k: torch.as_tensor(v) for k, v in trunk_state.items()})
        if lin_weights_path is not None:
            model.load_state_dict(load_lin_weights(lin_weights_path), strict=False)
        self.model = model.to(self.device).eval()

    def batch(self, gt01: torch.Tensor, pred01: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) tensors in [0, 1] (moved to the metric's device) -> (B, H, W) maps on it."""
        with torch.no_grad(), exact_convs():
            a = torch.as_tensor(gt01, dtype=torch.float32).to(self.device) * 2.0 - 1.0
            b = torch.as_tensor(pred01, dtype=torch.float32).to(self.device) * 2.0 - 1.0
            return self.model(a, b)

    def __call__(self, gt01: np.ndarray, pred01: np.ndarray) -> np.ndarray:
        return self.batch(torch.as_tensor(np.asarray(gt01, np.float32))[None],
                          torch.as_tensor(np.asarray(pred01, np.float32))[None])[0].cpu().numpy()

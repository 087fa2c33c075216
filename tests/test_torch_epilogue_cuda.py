"""The CNN's eval-mode epilogue kernel (csrc/epilogue.cu) against the eager path, on the card.

Each form of `layers.conv_bn_act` (the kernel after convolutions without
their bias) against the same call with `epilogue_cuda.use_fused`
monkeypatched to False (the eager composition after convolutions with
their bias), bit for bit and in the same memory order, at the main path's
shapes, at batch 1, at H*W not a multiple of 4 and C not a multiple of 4,
in NCHW and channels-last; RelightNet (target and transfer, tiers strict and
high, batch 64 and 1) and `Relighter.forward_visuals` the same way, with no
eager epilogue on the fused run; and a refused launch. The fused runs leave
the 16-channel 3x3 convolutions to cuDNN (ops/conv3x3_cuda.takes patched to
False), so that the epilogue kernel alone is compared bit for bit; with the
direct route on (csrc/conv3x3.cu, whose sums take another order) RelightNet
is held to the eager forward within float32 rounding. Every test needs an
NVIDIA GPU (marker `cuda`) and skips without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_epilogue_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

from geomconsistentfr_torch.config import apply_precision_tier, preset_single_image
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.models import layers
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.ops import conv3x3_cuda, cuda_lib
from geomconsistentfr_torch.ops import epilogue_cuda as E

pytestmark = pytest.mark.cuda

SLOPE = 0.2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the epilogue kernel has no CPU mode")
    return torch.device("cuda")


def random_bn(c, gen, dev):
    bn = layers.BatchNorm(c).eval()
    with torch.no_grad():
        bn.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
        bn.bias.copy_(0.3 * torch.randn(c, generator=gen))
    return bn.to(dev)


def randomize_bns(net, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, layers.BatchNorm):
            m.load_state_dict(random_bn(m.num_features, gen, "cpu").state_dict())


def both_paths(fn, monkeypatch, direct=False):
    """(fused result, eager result, the fused run's epilogue counts: 'fused' the launches of
    csrc/epilogue.cu and csrc/conv3x3.cu, 'eager' layers.EAGER_EPILOGUES), convolutions exact. The
    fused run leaves the 16-channel 3x3 convolutions to cuDNN (the direct route, which sums
    in another order, monkeypatched off) unless `direct`."""
    with torch.no_grad(), layers.exact_convs():
        cuda_lib.LAUNCHES.update(epilogue=0, conv3x3=0)
        layers.EAGER_EPILOGUES = 0
        with monkeypatch.context() as mp:
            if not direct:
                mp.setattr(conv3x3_cuda, "takes", lambda *args: False)
            got = fn()
        counts = {"fused": cuda_lib.LAUNCHES["epilogue"] + cuda_lib.LAUNCHES["conv3x3"],
                  "eager": layers.EAGER_EPILOGUES}
        with monkeypatch.context() as mp:
            mp.setattr(E, "use_fused", lambda *args: False)
            want = fn()
    torch.cuda.synchronize()
    return got, want, counts


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(got, want), (got - want).abs().max().item()


# (B, C, H, W) of the convolution's output: the 256^2 x 16 stages and the
# encoder's last (C = 155, not a multiple of 4) at batch 64, batch 1, and
# H*W not a multiple of 4.
SHAPES = [(64, 16, 256, 256), (64, 155, 16, 16), (1, 16, 64, 64), (3, 16, 15, 13), (2, 6, 9, 7)]
# The join's source maps: the decoders' last stage (128^2 -> 256^2), the first.
JOIN_SHAPES = [(64, 16, 128, 128), (64, 64, 16, 16), (64, 155, 16, 16), (1, 32, 32, 32), (3, 16, 15, 13),
               (2, 6, 9, 7)]
FORMS = ["plain", "residual", "two_affines", "shortcut_no_bias", "identity_act", "no_bias"]
JOIN_FORMS = ["residual", "residual_skip", "two_affines", "two_affines_skip"]


def form_call(shape, form, layout, dev, seed, join=False):
    """A closure running conv_bn_act on seeded inputs in `form`."""
    gen, dev_gen = torch.Generator().manual_seed(seed), torch.Generator(device=dev).manual_seed(seed)
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    b, c, h, w = shape

    def rand(*s):
        return torch.randn(*s, generator=dev_gen, device=dev).contiguous(memory_format=fmt)

    x, v, r = rand(b, c, h, w), rand(b, c, h, w), rand(b, c, h, w)
    skip = rand(b, c, 2 * h, 2 * w) if join else None
    layer = nn.ConvTranspose2d if join else nn.Conv2d
    conv = layer(c, c, 3, padding=1, bias=form != "no_bias").to(dev)
    short = (nn.Conv2d(c, c, 1, bias=False) if form == "shortcut_no_bias" else nn.Conv2d(c, c, 3, padding=1)).to(dev)
    main = layers.Branch(conv, random_bn(c, gen, dev), x, torch.float32)
    residual = None
    if form.startswith("residual"):
        residual = r
    elif form.startswith("two_affines") or form == "shortcut_no_bias":
        residual = layers.Branch(short, random_bn(c, gen, dev), v, torch.float32)
    slope = None if form == "identity_act" else SLOPE
    extra = dict(upsample=True, skip=skip if form.endswith("_skip") else None) if join else {}
    return lambda: layers.conv_bn_act(main, residual, slope, dtype=torch.float32, **extra)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bn_act_bit_equal_to_eager(dev, shape, form, layout, monkeypatch):
    got, want, counts = both_paths(form_call(shape, form, layout, dev, SHAPES.index(shape)), monkeypatch)
    assert counts == {"fused": 1, "eager": 0}
    assert_same(got, want)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("form", JOIN_FORMS)
@pytest.mark.parametrize("shape", JOIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_join_bit_equal_to_eager(dev, shape, form, layout, monkeypatch):
    call = form_call(shape, form, layout, dev, 100 + JOIN_SHAPES.index(shape), join=True)
    got, want, counts = both_paths(call, monkeypatch)
    assert counts == {"fused": 1, "eager": 0}
    assert_same(got, want)


EPILOGUES_PER_FORWARD = 9 + 2 * 19  # tests/test_torch_epilogue.py says which


@pytest.mark.parametrize("batch", [64, 1])
@pytest.mark.parametrize("tier", ["strict", "high"])
@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_relightnet_bit_equal_to_eager(dev, variant, tier, batch, monkeypatch):
    cfg = apply_precision_tier(preset_single_image(), tier).model
    net = RelightNet(dataclasses.replace(cfg, variant=variant), generator=torch.Generator().manual_seed(batch))
    randomize_bns(net, batch + 1)
    net = net.to(dev).eval()
    gen = torch.Generator().manual_seed(batch + 2)
    img = torch.rand(batch, 256, 256, 3, generator=gen).to(dev)
    for use_skips in ((True, True, True, True), (True, False, True, False)):
        got, want, counts = both_paths(lambda: net(img, use_skips), monkeypatch)
        assert counts == {"fused": EPILOGUES_PER_FORWARD, "eager": 0}
        for g, w in zip(got, want):
            assert_same(g, w)


# The direct route's largest difference from the eager forward over each output's largest
# magnitude: float32 sums in another order, through up to 16 layers after the first direct one.
DIRECT_REL_ERR = 1e-5


@pytest.mark.parametrize("batch", [64, 1])
@pytest.mark.parametrize("tier", ["strict", "high"])
@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_relightnet_direct_route_close_to_eager(dev, variant, tier, batch, monkeypatch):
    """The forward as Relighter runs it, the 18 16-channel 3x3 layers on csrc/conv3x3.cu,
    against the eager forward within float32 rounding."""
    cfg = apply_precision_tier(preset_single_image(), tier).model
    net = RelightNet(dataclasses.replace(cfg, variant=variant), generator=torch.Generator().manual_seed(batch))
    randomize_bns(net, batch + 1)
    net = net.to(dev).eval()
    img = torch.rand(batch, 256, 256, 3, generator=torch.Generator().manual_seed(batch + 2)).to(dev)
    got, want, counts = both_paths(lambda: net(img), monkeypatch, direct=True)
    assert counts == {"fused": EPILOGUES_PER_FORWARD, "eager": 0} and cuda_lib.LAUNCHES["conv3x3"] == 18
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.double() - w.double()).abs().max().item() / w.abs().max().item()
        assert err <= DIRECT_REL_ERR, err


def test_relighter_forward_visuals_bit_equal_to_eager(dev, monkeypatch):
    cfg = apply_precision_tier(preset_single_image(), "high")
    net = RelightNet(cfg.model, generator=torch.Generator().manual_seed(3))
    randomize_bns(net, 4)
    rl = Relighter(cfg, net.state_dict(), device=dev)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    masks = (rng.uniform(size=(4, 256, 256)) > 0.3).astype(np.uint8) * 255
    light = np.asarray([[0.3, 0.4, 0.87]] * 4, np.float32)
    got, want, counts = both_paths(lambda: rl.forward_visuals(images, masks, light), monkeypatch)
    assert counts == {"fused": EPILOGUES_PER_FORWARD, "eager": 0}
    assert torch.equal(got, want)


def test_refused_launch_raises(dev, monkeypatch):
    u = torch.zeros(2, 4, 8, 8, device=dev)
    vec = torch.zeros(5, 4, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = E.LIBRARY.load()["epilogue"]
    # The launcher refuses what it does not take (here no channels) with cudaErrorInvalidValue.
    assert launch(u.data_ptr(), vec.data_ptr(), 0, None, None, 0, None, u.data_ptr(),
                  2, 0, 8, 8, 0, 0, 1, SLOPE, stream) == 1

    monkeypatch.setattr(E.LIBRARY, "load", lambda: {"epilogue": lambda *args: 1})
    cuda_lib.LAUNCHES.update(epilogue=0)
    layers.EAGER_EPILOGUES = 0
    with pytest.raises(RuntimeError, match="epilogue kernel launch failed"):
        E.bn_act(E.Affine(u, vec, False), None, SLOPE)
    # a refused launch is not counted
    assert cuda_lib.LAUNCHES["epilogue"] == 0 and layers.EAGER_EPILOGUES == 0

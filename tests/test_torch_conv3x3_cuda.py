"""The direct 3x3 convolution with its epilogue (csrc/conv3x3.cu) on the card.

`layers.conv_bn_act` on the direct route against a float64 F.conv2d (or
F.conv_transpose2d) followed by the eager epilogue in float64, at relative
error <= 1e-5 of the output's largest magnitude, in every epilogue form
(no residual, a plain residual, a projection shortcut, the identity without
a bias, the join with and without the skip, and with the shortcut), at the
forward's shapes, at batch 1 and 8, and at an H x W that is no multiple of
the 8 x 32 tile; two launches, and two processes running RelightNet at batch
1 and 64, give the same bits; every refused input raises before any launch,
and a refused launch raises. Every test needs an NVIDIA GPU (marker `cuda`)
and skips without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3x3_cuda.py
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from geomconsistentfr_torch.models import layers
from geomconsistentfr_torch.ops import conv3x3_cuda as D
from geomconsistentfr_torch.ops import cuda_lib

pytestmark = pytest.mark.cuda

SLOPE = 0.2
REL_ERR = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the direct convolution kernel has no CPU mode")
    return torch.device("cuda")


def random_bn(c, gen, dev):
    bn = layers.BatchNorm(c).eval()
    with torch.no_grad():
        bn.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
        bn.bias.copy_(0.3 * torch.randn(c, generator=gen))
    return bn.to(dev)


def affine64(br: layers.Branch, u):
    """The branch's bias and eval-mode BatchNorm on u, in float64."""
    bn, view = br.bn, (1, -1, 1, 1)
    if br.conv.bias is not None:
        u = u + br.conv.bias.double().view(view)
    inv = torch.rsqrt(bn.running_var.double() + bn.eps)
    return (u - bn.running_mean.double().view(view)) * inv.view(view) * bn.weight.double().view(view) \
        + bn.bias.double().view(view)


def conv64(conv, x):
    w = conv.weight.double()
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x.double(), w, padding=conv.padding)
    return F.conv2d(x.double(), w, padding=conv.padding)


def form_case(shape, form, dev, seed, transposed=False):
    """(conv_bn_act on seeded inputs in `form`, its float64 value by the eager formulas)."""
    gen, dev_gen = torch.Generator().manual_seed(seed), torch.Generator(device=dev).manual_seed(seed)
    b, c, h, w = shape

    def rand(*s):
        return torch.randn(*s, generator=dev_gen, device=dev).contiguous(memory_format=torch.channels_last)

    layer = nn.ConvTranspose2d if transposed else nn.Conv2d
    main = layers.Branch(layer(c, c, 3, padding=1, bias=form != "identity_act_no_bias").to(dev),
                         random_bn(c, gen, dev), rand(b, c, h, w), torch.float32)
    residual = None
    if "shortcut" in form:
        residual = layers.Branch(layer(2 * c, c, 3, padding=1).to(dev), random_bn(c, gen, dev), rand(b, 2 * c, h, w),
                                 torch.float32)
    elif form not in ("plain", "identity_act_no_bias"):
        residual = rand(b, c, h, w)
    slope = None if form == "identity_act_no_bias" else SLOPE
    join = form.startswith("join")
    skip = rand(b, c, 2 * h, 2 * w) if form.endswith("skip") else None

    def call():
        extra = dict(upsample=True, skip=skip) if join else {}
        return layers.conv_bn_act(main, residual, slope, dtype=torch.float32, **extra)

    def want():
        y = affine64(main, conv64(main.conv, main.x))
        if isinstance(residual, layers.Branch):
            y = affine64(residual, conv64(residual.conv, residual.x)) + y
        elif residual is not None:
            y = residual.double() + y
        if slope is not None:
            y = torch.where(y >= 0, y, slope * y)
        if join:
            y = F.interpolate(y, scale_factor=2, mode="nearest")
            if skip is not None:
                y = y + skip.double()
        return y

    return call, want


def run_direct(call):
    """call() on the direct route, with cuDNN's deterministic float32 algorithms for any other
    convolution (a shortcut), as Relighter runs the CNN; asserts it was one direct launch."""
    with torch.no_grad(), layers.exact_convs():
        cuda_lib.LAUNCHES.update(epilogue=0, conv3x3=0)
        layers.EAGER_EPILOGUES = 0
        got = call()
        torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["conv3x3"] == 1
    assert cuda_lib.LAUNCHES["epilogue"] + cuda_lib.LAUNCHES["conv3x3"] == 1 and layers.EAGER_EPILOGUES == 0
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == torch.float32
    return got


def assert_rel_err(got, want):
    err = (got.double() - want).abs().max().item() / want.abs().max().item()
    assert err <= REL_ERR, err


SHAPES = [(64, 16, 256, 256), (64, 16, 128, 128), (1, 16, 256, 256), (8, 16, 64, 64), (3, 16, 240, 250)]
FORMS = ["plain", "residual", "shortcut", "identity_act_no_bias", "join", "join_skip", "join_shortcut_skip"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_direct_route_against_float64(dev, shape, form):
    call, want = form_case(shape, form, dev, SHAPES.index(shape) * 10 + FORMS.index(form))
    got = run_direct(call)
    with torch.no_grad():
        assert_rel_err(got, want())


@pytest.mark.parametrize("form", ["plain", "join_skip", "join_shortcut_skip"])
@pytest.mark.parametrize("shape", [(64, 16, 128, 128), (8, 16, 64, 64), (2, 16, 37, 45)],
                         ids=lambda s: "x".join(map(str, s)))
def test_transposed_route_against_conv_transpose2d(dev, shape, form):
    """A stride-1 ConvTranspose2d (the decoders' h7_2, h8_1, h8_2) through its transformed weights."""
    call, want = form_case(shape, form, dev, 100 + FORMS.index(form), transposed=True)
    got = run_direct(call)
    with torch.no_grad():
        assert_rel_err(got, want())


@pytest.mark.parametrize("form", ["residual", "join_skip"])
@pytest.mark.parametrize("shape", [(64, 16, 256, 256), (1, 16, 256, 256), (3, 16, 240, 250)],
                         ids=lambda s: "x".join(map(str, s)))
def test_two_launches_are_bit_equal(dev, shape, form):
    call, _ = form_case(shape, form, dev, 200)
    first = run_direct(call)
    again = run_direct(call)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))


# One process's RelightNet forward on the direct route: seeded weights and BatchNorm
# statistics, a seeded image batch, tier high (float32), as Relighter runs it.
CHILD = """
import sys, torch
from geomconsistentfr_torch.config import apply_precision_tier, preset_single_image
from geomconsistentfr_torch.models import layers
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.ops import conv3x3_cuda as D
from geomconsistentfr_torch.ops import cuda_lib
out, batch = sys.argv[1], int(sys.argv[2])
cfg = apply_precision_tier(preset_single_image(), "high").model
net = RelightNet(cfg, generator=torch.Generator().manual_seed(0))
gen = torch.Generator().manual_seed(1)
for m in net.modules():
    if isinstance(m, layers.BatchNorm):
        with torch.no_grad():
            m.running_mean.copy_(0.3 * torch.randn(m.num_features, generator=gen))
            m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
net = net.cuda().eval()
img = torch.rand(batch, 256, 256, 3, generator=torch.Generator().manual_seed(2)).cuda()
with torch.no_grad(), layers.deterministic_convs():
    cuda_lib.LAUNCHES.update(conv3x3=0)
    outs = net(img)
    assert cuda_lib.LAUNCHES["conv3x3"] == 18, cuda_lib.LAUNCHES
torch.save([t.cpu() for t in outs], out)
"""


@pytest.mark.parametrize("batch", [1, 64])
def test_two_processes_are_bit_equal(dev, batch, tmp_path):
    root = Path(__file__).resolve().parents[1]
    outs = []
    for i in range(2):
        path = tmp_path / f"out{i}.pt"
        proc = subprocess.run([sys.executable, "-c", CHILD, str(path), str(batch)], cwd=root, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        outs.append(torch.load(path))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def valid_conv(dev, **change):
    """A valid direct call's Conv on the card, with `change` applied."""
    x = torch.randn(2, 16, 8, 8, device=dev).contiguous(memory_format=torch.channels_last)
    conv = nn.Conv2d(16, 16, 3, padding=1).to(dev)
    with torch.no_grad():
        c = D.Conv(x, D.taps(conv), layers.BatchNorm(16).to(dev).eval().eval_vectors(conv.bias), True)
    return c._replace(**change)


@pytest.mark.parametrize("case", ["nchw", "channels", "bfloat16", "vectors"])
def test_refused_inputs_raise_before_any_launch(dev, case, monkeypatch):
    x = valid_conv(dev).x
    change = {
        "nchw": dict(x=x.contiguous()),
        "channels": dict(x=torch.zeros(2, 8, 8, 8, device=dev).contiguous(memory_format=torch.channels_last)),
        "bfloat16": dict(x=x.to(torch.bfloat16)),
        "vectors": dict(vec=torch.zeros(5, 8, device=dev)),
    }[case]
    monkeypatch.setattr(D.LIBRARY, "load", lambda: pytest.fail("the launcher was reached"))
    cuda_lib.LAUNCHES.update(conv3x3=0)
    with pytest.raises((ValueError, TypeError)):
        D.bn_act(valid_conv(dev, **change), None, SLOPE)
    assert cuda_lib.LAUNCHES["conv3x3"] == 0


def test_refused_launch_raises(dev, monkeypatch):
    c = valid_conv(dev)
    out = torch.empty_like(c.x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The launcher refuses what it does not take (here no rows) with cudaErrorInvalidValue.
    assert D.LIBRARY.load()["conv3x3"](c.x.data_ptr(), c.w.data_ptr(), c.vec.data_ptr(), 1, None, None, 0, None,
                                       out.data_ptr(), 2, 0, 8, 0, 1, SLOPE, stream) == 1

    monkeypatch.setattr(D.LIBRARY, "load", lambda: {"conv3x3": lambda *args: 1})
    cuda_lib.LAUNCHES.update(conv3x3=0)
    with pytest.raises(RuntimeError, match="conv3x3 kernel launch failed"):
        D.bn_act(c, None, SLOPE)
    assert cuda_lib.LAUNCHES["conv3x3"] == 0  # a refused launch is not counted

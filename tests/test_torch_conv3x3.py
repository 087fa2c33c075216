"""The direct 3x3 convolution's route and its wrapper (ops/conv3x3_cuda.py) on the CPU.

`takes`, the one predicate by which `layers.conv_bn_act` runs a convolution
in csrc/conv3x3.cu: which of RelightNet's layers it picks in both variants,
and the `cuda_lib.LAUNCHES["conv3x3"]` counts of a forward and of an estimate pass with the card
forced (the predicates see a CUDA tensor; each launch runs the plain
version), none off the card, in train mode, with autograd or in bfloat16;
the ConvTranspose2d -> conv2d weight transform against F.conv_transpose2d
in float64 and its cache after a load_state_dict; the plain version's
epilogue against the epilogue kernel's plain model bit for bit; and the
wrapper's checks, which run before any launch and refuse CPU tensors. The
kernel itself is held on the card (tests/test_torch_conv3x3_cuda.py).
"""

import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from geomconsistentfr_torch.models import layers
from geomconsistentfr_torch.ops import conv3x3_cuda as D
from geomconsistentfr_torch.ops import cuda_lib
from geomconsistentfr_torch.ops import epilogue_cuda as E
from test_torch_epilogue import SLOPE, cpu_net, epilogue_counts, kernel_model, random_bn, reset_counts

# The layers the direct route takes: 16 -> 16, 3x3, stride 1, padding 1 (both decoders, then the encoder).
DECODER_LAYERS = ("conv_{p}_skip_s3_1", "conv_{p}_skip_s3_2", "conv_{p}_skip_s4_1", "conv_{p}_skip_s4_2",
                  "deconv_{p}_h7_2", "deconv_{p}_h8_1", "deconv_{p}_h8_2", "conv_{p}_c2_1")
DIRECT_LAYERS = sorted([n.format(p=p) for p in ("albedo", "depth") for n in DECODER_LAYERS]
                       + ["conv_h1_1", "conv_h1_2"])
DIRECT_PER_FORWARD, DIRECT_PER_ESTIMATE = 18, 2


def force_card(mp, picked: list) -> None:
    """Take the fused path's device condition as met on the CPU (every other condition of
    `use_fused` still applies); each direct launch runs `plain` and counts as the kernel's
    accepted launch would, each epilogue launch runs kernel_model (uncounted); `picked`
    receives each convolution module the direct route takes."""
    real_use_fused, real_takes = E.use_fused, D.takes
    card = types.SimpleNamespace(is_cuda=True)

    def takes(conv, x, dtype):
        ok = real_takes(conv, x, dtype)
        if ok:
            picked.append(conv)
        return ok

    def direct(*args):
        cuda_lib.LAUNCHES["conv3x3"] += 1
        return D.plain(*args)

    mp.setattr(E, "use_fused", lambda x, dtype, *bns: real_use_fused(card, dtype, *bns))
    mp.setattr(E, "_launch", kernel_model)
    mp.setattr(D, "_launch", direct)
    mp.setattr(D, "takes", takes)


@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_direct_route_per_layer_and_count_per_forward(variant, monkeypatch):
    """With the card forced: the 18 16-channel 3x3 layers, and no other, run the direct
    kernel, once each a forward; every other epilogue is epilogue.cu's; the outputs are the
    eager forward's within float32 rounding (the plain version sums as F.conv2d does)."""
    img = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(11))
    net = cpu_net(variant, seed=12)
    names = {m: n for n, m in net.named_modules()}
    with torch.no_grad():
        reset_counts()
        want = net(img)
        assert cuda_lib.LAUNCHES["conv3x3"] == 0 and epilogue_counts() == {"fused": 0, "eager": 47}
        picked = []
        with monkeypatch.context() as mp:
            force_card(mp, picked)
            reset_counts()
            got = net(img)
        assert sorted(names[m] for m in picked) == DIRECT_LAYERS
        assert cuda_lib.LAUNCHES["conv3x3"] == DIRECT_PER_FORWARD
        # 'fused' counts the direct kernel's epilogues; epilogue.cu's launches run kernel_model here.
        assert epilogue_counts() == {"fused": DIRECT_PER_FORWARD, "eager": 0}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)


@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_direct_route_count_per_estimate(variant, monkeypatch):
    img = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(13))
    net = cpu_net(variant, seed=14)
    names = {m: n for n, m in net.named_modules()}
    picked = []
    force_card(monkeypatch, picked)
    with torch.no_grad():
        reset_counts()
        net.estimate(img)
    assert sorted(names[m] for m in picked) == ["conv_h1_1", "conv_h1_2"]
    assert cuda_lib.LAUNCHES["conv3x3"] == DIRECT_PER_ESTIMATE


@pytest.mark.parametrize("variant", ["target", "transfer"])
@pytest.mark.parametrize("case", ["cpu_eval", "train_mode", "grad_enabled", "bfloat16"])
def test_no_direct_route(case, variant, monkeypatch):
    """Off the card, and with the card forced in train mode, with autograd on or with
    bfloat16 activations, no convolution takes the direct route: every epilogue is eager."""
    img = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(15))
    net = cpu_net(variant, compute_dtype="bfloat16" if case == "bfloat16" else "float32", seed=16)
    picked = []
    if case != "cpu_eval":
        force_card(monkeypatch, picked)
    if case == "train_mode":
        net.train()
    reset_counts()
    if case == "grad_enabled":
        net(img)
    else:
        with torch.no_grad():
            net(img)
    assert picked == [] and cuda_lib.LAUNCHES["conv3x3"] == 0
    assert epilogue_counts() == {"fused": 0, "eager": 47}


def conv16(transposed=False, **kw):
    args = dict(kernel_size=3, padding=1)
    args.update(kw)
    layer = nn.ConvTranspose2d if transposed else nn.Conv2d
    return layer(args.pop("cin", 16), args.pop("cout", 16), **args)


def cl_map(*shape, dtype=torch.float32):
    return torch.randn(*shape, dtype=dtype, generator=torch.Generator().manual_seed(17)).contiguous(
        memory_format=torch.channels_last)


def misaligned_map(b=2, c=16, h=4, w=4):
    base = torch.zeros(1 + b * c * h * w)
    return base[1:].view(b, h, w, c).permute(0, 3, 1, 2)  # channels-last strides, data 4 bytes off


TAKES_CASES = {
    "conv2d": (conv16(), cl_map(2, 16, 5, 7), torch.float32, True),
    "conv_transpose2d": (conv16(True), cl_map(2, 16, 5, 7), torch.float32, True),
    "no_bias": (conv16(bias=False), cl_map(1, 16, 4, 4), torch.float32, True),
    "in_channels": (conv16(cin=32), cl_map(2, 32, 5, 7), torch.float32, False),
    "out_channels": (conv16(cout=32), cl_map(2, 16, 5, 7), torch.float32, False),
    "kernel_1x1": (conv16(kernel_size=1, padding=0), cl_map(2, 16, 5, 7), torch.float32, False),
    "stride_2": (conv16(stride=2), cl_map(2, 16, 8, 8), torch.float32, False),
    "padding_0": (conv16(padding=0), cl_map(2, 16, 8, 8), torch.float32, False),
    "dilation_2": (conv16(dilation=2), cl_map(2, 16, 8, 8), torch.float32, False),
    "nchw_input": (conv16(), torch.randn(2, 16, 5, 7), torch.float32, False),
    "float64_input": (conv16(), cl_map(2, 16, 5, 7, dtype=torch.float64), torch.float32, False),
    "bfloat16_conv": (conv16(), cl_map(2, 16, 5, 7), torch.bfloat16, False),
    "misaligned_input": (conv16(), misaligned_map(), torch.float32, False),
}


@pytest.mark.parametrize("case", sorted(TAKES_CASES))
def test_takes_reads_shape_layout_and_dtype(case):
    conv, x, dtype, expected = TAKES_CASES[case]
    assert D.takes(conv, x, dtype) is expected


@pytest.mark.parametrize("shape", [(2, 16, 9, 7), (1, 16, 1, 1), (3, 16, 16, 5)])
def test_transposed_weight_is_conv_transpose2d(shape):
    """F.conv2d with conv_weight(ConvTranspose2d) is F.conv_transpose2d, in float64; `taps`
    holds the same weights in the kernel's [ky * 3 + kx][ci][co] layout."""
    gen = torch.Generator().manual_seed(18)
    m = conv16(True).double()
    x = torch.randn(*shape, dtype=torch.float64, generator=gen)
    want = F.conv_transpose2d(x, m.weight, None, padding=1)
    got = F.conv2d(x, D.conv_weight(m), None, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    taps = D.taps(m)
    assert taps.shape == (9, 16, 16) and taps.is_contiguous()
    for ky in range(3):
        for kx in range(3):
            assert torch.equal(taps[3 * ky + kx], m.weight[:, :, 2 - ky, 2 - kx])


@pytest.mark.parametrize("transposed", [False, True])
def test_taps_follow_their_weight(transposed):
    gen = torch.Generator().manual_seed(19)
    m, other = conv16(transposed), conv16(transposed)

    def expected():
        return D.conv_weight(m).permute(2, 3, 1, 0).reshape(9, 16, 16)

    with torch.no_grad():
        first = D.taps(m)
        assert torch.equal(first, expected())
        assert D.taps(m) is first  # cached while nothing changes
        m.load_state_dict(other.state_dict())
        after_load = D.taps(m)
        assert after_load is not first and torch.equal(after_load, expected())
        assert not torch.equal(after_load, first)
        m.weight.mul_(2.0)
        assert torch.equal(D.taps(m), expected())
        m.weight = nn.Parameter(torch.randn(16, 16, 3, 3, generator=gen))
        assert torch.equal(D.taps(m), expected())


def test_relightnet_direct_route_follows_load_state_dict(monkeypatch):
    """A state dict loaded after a forward on the direct route: the next forward reads its weights."""
    img = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(20))
    net, other = cpu_net(seed=21), cpu_net(seed=22)
    force_card(monkeypatch, [])
    with torch.no_grad():
        net(img)
        net.load_state_dict(other.state_dict())
        got, want = net(img), other(img)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


FORMS = ["plain", "residual", "shortcut", "identity_act_no_bias", "join", "join_skip", "join_shortcut_skip"]


@pytest.mark.parametrize("form", FORMS)
def test_plain_epilogue_is_the_epilogue_kernels(form):
    """`plain` is F.conv2d, then the epilogue kernel's plain model bit for bit, in every form."""
    gen = torch.Generator().manual_seed(23 + FORMS.index(form))
    b, h, w = 2, 6, 5
    x, r = cl_map(b, 16, h, w), torch.randn(b, 16, h, w, generator=gen).contiguous(memory_format=torch.channels_last)
    conv = conv16(bias=form != "identity_act_no_bias")
    bias = conv.bias
    with torch.no_grad():
        c = D.Conv(x, D.taps(conv), random_bn(16, gen).eval_vectors(bias), bias is not None)
        residual = None
        if "shortcut" in form:
            residual = E.Affine(r, random_bn(16, gen).eval_vectors(torch.randn(16, generator=gen)), True)
        elif form != "identity_act_no_bias" and form != "plain":
            residual = r
        join = form.startswith("join")
        skip = torch.randn(b, 16, 2 * h, 2 * w, generator=gen) if form.endswith("skip") else None
        slope = None if form == "identity_act_no_bias" else SLOPE
        got = D.plain(c, residual, slope, join, skip)
        want = kernel_model(E.Affine(F.conv2d(x, D.conv_weight(conv), padding=1), c.vec, c.has_bias), residual,
                            slope, join, skip)
    assert torch.equal(got, want) and (got != 0).any()


def launch_args(**change):
    """A valid direct call's arguments on CPU tensors, with `change` applied."""
    x = cl_map(2, 16, 6, 6)
    conv = conv16()
    with torch.no_grad():
        args = dict(c=D.Conv(x, D.taps(conv), layers.BatchNorm(16).eval().eval_vectors(conv.bias), True),
                    r=torch.zeros_like(x), slope=SLOPE, join=False, skip=None)
    args.update(change)
    return args


@pytest.mark.parametrize("case", ["nchw", "channels", "bfloat16", "vectors", "taps", "residual_layout",
                                  "residual_shape", "residual_misaligned", "shortcut_vectors", "skip_without_join",
                                  "skip_shape", "cpu"])
def test_launch_checks_raise_before_any_launch(case, monkeypatch):
    base = launch_args()
    c = base["c"]
    change, match = {
        "nchw": (dict(c=c._replace(x=c.x.contiguous())), "memory order"),
        "channels": (dict(c=c._replace(x=cl_map(2, 8, 6, 6))), "shape"),
        "bfloat16": (dict(c=c._replace(x=c.x.to(torch.bfloat16))), "float32"),
        "vectors": (dict(c=c._replace(vec=torch.zeros(4, 16))), r"\(5, 16\)"),
        "taps": (dict(c=c._replace(w=torch.zeros(16, 16, 3, 3))), r"\(9, 16, 16\)"),
        "residual_layout": (dict(r=torch.zeros(2, 16, 6, 6)), "memory order"),
        "residual_shape": (dict(r=cl_map(2, 16, 6, 5)), "shape"),
        "residual_misaligned": (dict(r=misaligned_map(2, 16, 6, 6)), "aligned"),
        "shortcut_vectors": (dict(r=E.Affine(cl_map(2, 16, 6, 6), torch.zeros(5, 8), True)), r"\(5, 16\)"),
        "skip_without_join": (dict(skip=cl_map(2, 16, 12, 12)), "skip"),
        "skip_shape": (dict(join=True, skip=cl_map(2, 16, 6, 6)), "shape"),
        "cpu": ({}, "CUDA tensors"),  # every check passes: the device refuses
    }[case]
    monkeypatch.setattr(D.LIBRARY, "load", lambda: pytest.fail("the launcher was reached"))
    with pytest.raises((ValueError, TypeError), match=match):
        D._launch(**launch_args(**change))

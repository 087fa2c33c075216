"""The CNN's eval-mode epilogue (ops/epilogue_cuda.py) on the CPU.

The plain version of the kernel's arithmetic (`kernel_model`: csrc/epilogue.cu's
operations in its order, from the bias-free convolution output and the (5, C)
vectors) against the eager composition of models/layers.py bit for bit, in
every form, on random BatchNorm statistics; the one predicate that picks the
fused path and the epilogue counts (`cuda_lib.LAUNCHES` of the two kernels,
`layers.EAGER_EPILOGUES`); RelightNet with the fused path forced on
the CPU (the launch replaced by `kernel_model`, the direct convolution of
ops/conv3x3_cuda.py off) against its eager forward; the
vector cache after a load_state_dict and an in-place change; and the wrapper's
checks, which run before any launch and refuse CPU tensors. The kernel itself
is held against the eager path on the card (tests/test_torch_epilogue_cuda.py).
"""

import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from geomconsistentfr_torch.config import ModelConfig
from geomconsistentfr_torch.models import layers
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.ops import conv3x3_cuda, cuda_lib
from geomconsistentfr_torch.ops import epilogue_cuda as E

SLOPE = 0.2


def random_bn(c: int, gen: torch.Generator) -> layers.BatchNorm:
    bn = layers.BatchNorm(c).eval()
    with torch.no_grad():
        bn.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
        bn.bias.copy_(0.3 * torch.randn(c, generator=gen))
    return bn


def randomize_bns(net: nn.Module, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, layers.BatchNorm):
            fresh = random_bn(m.num_features, gen)
            m.load_state_dict(fresh.state_dict())


def eager_affine(u, bias, bn):
    """What the eager path computes after a convolution: cuDNN's bias add, then the BatchNorm."""
    return bn(u if bias is None else u + bias.view(1, -1, 1, 1), torch.float32)


def affine(u, bias, bn):
    return E.Affine(u, bn.eval_vectors(bias), bias is not None)


def affine_model(a: E.Affine) -> torch.Tensor:
    b, mean, inv, gamma, beta = (v.view(1, -1, 1, 1) for v in a.vec)
    x = a.x + b if a.has_bias else a.x
    return (x - mean) * inv * gamma + beta


def kernel_model(a, r, slope, join, skip):
    """What the kernel computes (epilogue_cuda._launch's arguments), op for op in its order."""
    y = affine_model(a)
    if r is not None:
        y = (affine_model(r) if isinstance(r, E.Affine) else r) + y
    if slope is not None:
        y = torch.where(y >= 0, y, slope * y)
    if join:
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        if skip is not None:
            y = y + skip
    return y


def force_fused(mp, launches: list) -> None:
    """Take the fused path on the CPU: the predicate holds and each launch runs kernel_model;
    the direct convolution (ops/conv3x3_cuda.py) is off, so that every epilogue is this kernel's."""
    mp.setattr(E, "use_fused", lambda *args: True)
    mp.setattr(E, "_launch", lambda *args: launches.append(args[3]) or kernel_model(*args))
    mp.setattr(conv3x3_cuda, "takes", lambda *args: False)


FORMS = ["plain", "residual", "two_affines", "identity_act", "no_bias", "join", "join_skip", "join_two_affines"]


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_epilogue_equals_eager_composition(form, layout):
    gen = torch.Generator().manual_seed(FORMS.index(form))
    b, c, h, w = 3, 6, 7, 5

    def rand(*shape):
        t = torch.randn(*shape, generator=gen)
        return t.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else t

    u, v, r = rand(b, c, h, w), rand(b, c, h, w), rand(b, c, h, w)
    skip = rand(b, c, 2 * h, 2 * w)
    bias = None if form == "no_bias" else torch.randn(c, generator=gen)
    bias2 = torch.randn(c, generator=gen)
    bn, bn2 = random_bn(c, gen), random_bn(c, gen)
    slope = None if form == "identity_act" else SLOPE
    join = form.startswith("join")

    want = eager_affine(u, bias, bn)
    got_r = None
    if form in ("residual", "join", "join_skip"):
        want, got_r = r + want, r
    elif form in ("two_affines", "join_two_affines"):
        want, got_r = eager_affine(v, bias2, bn2) + want, affine(v, bias2, bn2)
    if slope is not None:
        want = layers.leaky_relu(want, slope)
    if join:
        want = layers.upsample2_nearest(want)
        if form == "join_skip":
            want = want + skip
    got = kernel_model(affine(u, bias, bn), got_r, slope, join, skip if form == "join_skip" else None)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert (got != 0).any()  # a non-trivial comparison


def test_use_fused_predicate():
    bn = layers.BatchNorm(4).eval()
    card = types.SimpleNamespace(is_cuda=True)  # all the predicate reads of the tensor
    with torch.no_grad():
        assert E.use_fused(card, torch.float32, bn)
        assert not E.use_fused(torch.zeros(1), torch.float32, bn)        # a CPU tensor
        assert not E.use_fused(card, torch.bfloat16, bn)                 # the fast and draft tiers
        assert not E.use_fused(card, torch.float32, bn, layers.BatchNorm(4).train())  # train mode
    assert not E.use_fused(card, torch.float32, bn)                      # autograd on


def cpu_net(variant="target", compute_dtype="float32", seed=0):
    net = RelightNet(ModelConfig(variant=variant, compute_dtype=compute_dtype),
                     generator=torch.Generator().manual_seed(seed))
    randomize_bns(net, seed + 1)
    return net.eval()


def reset_counts():
    cuda_lib.LAUNCHES.update(epilogue=0, conv3x3=0)
    layers.EAGER_EPILOGUES = 0


def epilogue_counts() -> dict:
    """The epilogues since reset_counts: 'fused' those a hand-written kernel computed (the
    launches of csrc/epilogue.cu and of csrc/conv3x3.cu), 'eager' the eager compositions."""
    return {"fused": cuda_lib.LAUNCHES["epilogue"] + cuda_lib.LAUNCHES["conv3x3"], "eager": layers.EAGER_EPILOGUES}


def count_epilogues(net, img, **kw):
    reset_counts()
    out = net(img, **kw)
    return out, epilogue_counts()


# Epilogues a forward evaluates: the encoder's 9 (c1_og, h1_1, h1_2, two a
# stage, the second with its projection shortcut's BatchNorm), each decoder's 19
# (four a stage: two of the skip branch, the first deconv, the join; then c2_1-3).
EPILOGUES_PER_FORWARD = 9 + 2 * 19


@pytest.mark.parametrize("case", ["cpu_eval", "train_mode", "grad_enabled", "bfloat16"])
def test_dispatch_counts(case):
    img = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    net = cpu_net(compute_dtype="bfloat16" if case == "bfloat16" else "float32")
    if case == "train_mode":
        net.train()
    if case == "grad_enabled":
        assert all(p.requires_grad for p in net.parameters())
        _, counts = count_epilogues(net, img)
    else:
        with torch.no_grad():
            _, counts = count_epilogues(net, img)
    assert counts == {"fused": 0, "eager": EPILOGUES_PER_FORWARD}


@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_relightnet_fused_path_equals_eager(variant, monkeypatch):
    """The fused path forced on the CPU (convolutions without their bias, the kernel's
    plain model) against the eager forward, every output bit for bit, skips on and off:
    every epilogue of the forward goes through one launch, four of them joins."""
    img = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    net = cpu_net(variant, seed=5)
    for use_skips in ((True, True, True, True), (False, True, False, True)):
        with torch.no_grad():
            want, counts = count_epilogues(net, img, use_skips=use_skips)
            assert counts == {"fused": 0, "eager": EPILOGUES_PER_FORWARD}
            launches = []
            with monkeypatch.context() as mp:
                force_fused(mp, launches)
                got, counts = count_epilogues(net, img, use_skips=use_skips)
            assert counts == {"fused": 0, "eager": 0}  # 'fused' counts the kernel's launches alone
            assert len(launches) == EPILOGUES_PER_FORWARD and sum(launches) == 2 * 4
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_eval_vectors_follow_their_sources():
    gen = torch.Generator().manual_seed(6)
    conv = nn.Conv2d(3, 4, 3)
    bn = random_bn(4, gen)

    def expected():
        return torch.stack([conv.bias, bn.running_mean, torch.rsqrt(bn.running_var + bn.eps), bn.weight, bn.bias])

    with torch.no_grad():
        first = bn.eval_vectors(conv.bias)
        assert torch.equal(first, expected())
        assert bn.eval_vectors(conv.bias) is first  # cached while nothing changes

        bn.load_state_dict(random_bn(4, gen).state_dict())
        after_load = bn.eval_vectors(conv.bias)
        assert after_load is not first and torch.equal(after_load, expected())

        bn.running_var.mul_(2.0)
        after_inplace = bn.eval_vectors(conv.bias)
        assert torch.equal(after_inplace, expected())
        assert not torch.equal(after_inplace[2], after_load[2])

        conv.bias.add_(1.0)
        assert torch.equal(bn.eval_vectors(conv.bias), expected())

        no_bias = bn.eval_vectors(None)
        assert torch.equal(no_bias[0], torch.zeros(4)) and torch.equal(no_bias[1:], expected()[1:])


def test_relightnet_follows_load_state_dict(monkeypatch):
    """A state dict loaded after a fused forward: the next forward reads its statistics."""
    img = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(7))
    net, other = cpu_net(seed=8), cpu_net(seed=9)
    force_fused(monkeypatch, [])
    with torch.no_grad():
        net(img)
        net.load_state_dict(other.state_dict())
        got, want = net(img), other(img)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def launch_args(layout="nchw", **change):
    """A valid bn_act / join call's arguments, on CPU tensors, with `change` applied."""
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    bn = layers.BatchNorm(4).eval()
    u = torch.zeros(2, 4, 6, 6).contiguous(memory_format=fmt)
    args = dict(a=E.Affine(u, bn.eval_vectors(None), False), r=torch.zeros_like(u), slope=SLOPE, join=False,
                skip=None)
    args.update(change)
    return args


@pytest.mark.parametrize("case", ["layout_mismatch", "strided", "dtype", "shape", "vectors", "skip_without_join",
                                  "cpu"])
def test_launch_checks_raise_before_any_launch(case):
    base = launch_args()
    u = base["a"].x
    change, match = {
        "layout_mismatch": (dict(r=torch.zeros_like(u).contiguous(memory_format=torch.channels_last)), "memory order"),
        "strided": (dict(a=base["a"]._replace(x=torch.zeros(2, 4, 6, 12)[..., ::2])), "contiguous or channels-last"),
        "dtype": (dict(r=torch.zeros_like(u, dtype=torch.float64)), "float32"),
        "shape": (dict(r=torch.zeros(2, 4, 6, 5)), "shape"),
        "vectors": (dict(a=base["a"]._replace(vec=torch.zeros(4, 4))), r"\(5, 4\)"),
        "skip_without_join": (dict(skip=torch.zeros(2, 4, 12, 12)), "skip"),
        "cpu": ({}, "CUDA tensors"),  # every check passes: the device refuses
    }[case]
    reset_counts()
    with pytest.raises((ValueError, TypeError), match=match):
        E._launch(**launch_args(**change))
    assert epilogue_counts() == {"fused": 0, "eager": 0}


def test_conv_bn_act_refuses_a_skip_without_the_upsample():
    gen = torch.Generator().manual_seed(10)
    x = torch.randn(1, 3, 8, 8, generator=gen)
    with torch.no_grad(), pytest.raises(ValueError):
        layers.conv_bn_act(layers.Branch(nn.Conv2d(3, 4, 3, padding=1), random_bn(4, gen), x, torch.float32),
                           slope=SLOPE, dtype=torch.float32, skip=torch.zeros(1, 4, 16, 16))

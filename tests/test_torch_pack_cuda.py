"""The uint8 visual pack (csrc/pack.cu) on the card.

The kernel's pack against the eager `pack_visuals` (its plain version, run on
the card with the route turned off) byte for byte: at batch 1, 8 and 64, at
256^2 and at an H x W that is no multiple of the kernel's 256-pixel block; on
`render`'s own outputs, with their strides, through `forward_visuals` (one
'pack' launch a call at every batch size); on the edge inputs of
tests/test_torch_pack.py (values on and next to k/255 after the * 255, below 0
and above 1, fractional and zero masks, a constant-depth image, -0.0,
permuted maps) and on strided and expanded views. Every refused input raises
before any launch, and a launch the launcher refuses raises. Every test needs
an NVIDIA GPU (marker `cuda`) and skips without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_pack_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.infer import Relighter, pack_visuals
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.ops import cuda_lib
from geomconsistentfr_torch.ops import pack_cuda as P
from test_torch_pack import edge_maps, kernel_model, random_maps

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the pack kernel has no CPU mode")
    return torch.device("cuda")


def to(outputs, masks, dev):
    """(outputs, masks) on `dev`, each tensor with the strides it had."""
    def move(t):
        if t is None:
            return None
        out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=dev)
        return out.copy_(t)

    return outputs._replace(**{f: move(getattr(outputs, f)) for f in outputs._fields}), move(masks)


def eager(outputs, masks, mp) -> torch.Tensor:
    """pack_visuals' eager composition on the same (card) tensors."""
    with mp.context() as m:
        m.setattr(P, "takes", lambda *args: False)
        return pack_visuals(outputs, masks)


def kernel(outputs, masks) -> torch.Tensor:
    before = cuda_lib.LAUNCHES["pack"]
    assert P.takes(outputs, masks)
    got = pack_visuals(outputs, masks)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["pack"] == before + 1
    return got


SHAPES = [(1, 256, 256), (8, 256, 256), (64, 256, 256), (1, 17, 23), (8, 240, 250), (3, 1, 1), (2, 300, 7)]


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_kernel_is_the_eager_pack(dev, shape, permuted, monkeypatch):
    outputs, masks = to(*random_maps(*shape, seed=sum(shape), permuted=permuted), dev)
    got, want = kernel(outputs, masks), eager(outputs, masks, monkeypatch)
    assert got.shape == (*shape, 12) and got.dtype == torch.uint8 and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("shape", [(1, 256, 256), (8, 64, 64), (64, 256, 256), (3, 17, 23), (2, 70, 65)])
def test_kernel_is_the_eager_pack_on_edge_inputs(dev, shape, permuted, monkeypatch):
    cpu_outputs, cpu_masks = edge_maps(*shape, seed=sum(shape) + 1, permuted=permuted)
    outputs, masks = to(cpu_outputs, cpu_masks, dev)
    got, want = kernel(outputs, masks), eager(outputs, masks, monkeypatch)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), kernel_model(P._maps(cpu_outputs, cpu_masks)))


def test_constant_depth_and_zero_masks(dev, monkeypatch):
    outputs, masks = to(*random_maps(4, 33, 65, 3, permuted=True), dev)
    outputs = outputs._replace(depth=torch.full_like(outputs.depth, 12.5))
    masks = masks.clone()
    masks[1] = 0.0
    masks[2] = -0.0
    got, want = kernel(outputs, masks), eager(outputs, masks, monkeypatch)
    assert torch.equal(got, want) and (got[..., 7] == 0).all() and (got[1:3] == 0).all()


def test_strided_and_expanded_views(dev, monkeypatch):
    """Views with gaps (every other column of wider maps), expanded masks and depth (a zero
    batch stride), read by their strides: no copy, the eager bytes."""
    wide, masks = to(*random_maps(3, 40, 2 * 50, 4), dev)
    outputs = wide._replace(**{f: getattr(wide, f)[:, :, ::2] for f in P.CHANNEL_MAPS + P.PLANE_MAPS})
    masks = masks[:1, :, ::2].expand(3, 40, 50)
    outputs = outputs._replace(depth=outputs.depth[1:2].expand(3, 40, 50))
    assert not outputs.rendered.is_contiguous() and masks.stride()[0] == 0
    assert torch.equal(kernel(outputs, masks), eager(outputs, masks, monkeypatch))


def test_two_launches_are_bit_equal(dev):
    outputs, masks = to(*random_maps(8, 256, 256, 5, permuted=True), dev)
    assert torch.equal(kernel(outputs, masks), kernel(outputs, masks))


def relighter(dev, variant="target"):
    presets = {"target": TC.preset_single_image, "transfer": TC.preset_lighting_transfer}
    cfg = TC.apply_precision_tier(presets[variant](), "high")
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict()
    return Relighter(cfg, state, device=dev)


def batch(b, seed=1):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8)
    masks = (rng.random((b, 256, 256)) > 0.2).astype(np.float32)
    light = np.repeat(np.asarray([[0.3, 0.4, 0.87]], np.float32), b, 0)
    return imgs, masks, light


@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_render_outputs_and_forward_visuals(dev, variant, b, monkeypatch):
    """On render's own outputs, with their strides: the kernel's bytes are the eager pack's,
    and forward_visuals launches the kernel once a call."""
    rl = relighter(dev, variant)
    imgs, masks, light = batch(b)
    with torch.no_grad():
        outputs, m = rl._forward_local(imgs, masks, light, None)
    got, want = kernel(outputs, m), eager(outputs, m, monkeypatch)
    assert torch.equal(got, want)
    cuda_lib.LAUNCHES["pack"] = 0
    visuals = rl.forward_visuals(imgs, masks, light)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["pack"] == 1
    assert torch.equal(visuals, got)


def refused(dev, case):
    """(outputs, masks) on the card with one input the kernel does not read, and the error."""
    outputs, masks = to(*random_maps(2, 6, 5, 8, permuted=True), dev)
    if case == "float64_albedo":
        return outputs._replace(albedo=outputs.albedo.double()), masks, TypeError, "float32"
    if case == "bfloat16_masks":
        return outputs, masks.to(torch.bfloat16), TypeError, "float32"
    if case == "cpu_depth":
        return outputs._replace(depth=outputs.depth.cpu()), masks, ValueError, "depth is on cpu"
    if case == "cpu_masks":
        return outputs, masks.cpu(), ValueError, "is on cuda"
    if case == "normals_shape":
        return outputs._replace(surface_normals=outputs.surface_normals[..., :2]), masks, ValueError, "shape"
    if case == "shading_batch":
        return outputs._replace(final_shading=outputs.final_shading[:1]), masks, ValueError, "shape"
    if case == "masks_2d":
        return outputs, masks[0], ValueError, r"\(B, H, W\)"
    if case == "empty":
        return outputs, masks[:, :0], ValueError, "positive"
    raise AssertionError(case)


REFUSED = ["float64_albedo", "bfloat16_masks", "cpu_depth", "cpu_masks", "normals_shape", "shading_batch",
           "masks_2d", "empty"]


@pytest.mark.parametrize("case", REFUSED)
def test_refused_inputs_raise_before_any_launch(dev, case, monkeypatch):
    outputs, masks, error, match = refused(dev, case)
    monkeypatch.setattr(P.LIBRARY, "load", lambda: pytest.fail("the launcher was reached"))
    before = cuda_lib.LAUNCHES["pack"]
    assert not P.takes(outputs, masks)
    with pytest.raises(error, match=match):
        P.pack(outputs, masks)
    assert cuda_lib.LAUNCHES["pack"] == before


def test_a_refused_launch_raises(dev):
    """The launcher refuses an image of no pixels: the wrapper's launch raises and counts nothing."""
    before = cuda_lib.LAUNCHES["pack"]
    out = torch.empty(4, device=dev, dtype=torch.uint8)
    strides = (P.ctypes.c_longlong * 24)()
    with pytest.raises(RuntimeError, match="^pack kernel launch failed: CUDA error"):
        P.LIBRARY.launch("pack", dev, *([out.data_ptr()] * 7), strides, out.data_ptr(), out.data_ptr(), 1, 0, 4)
    assert cuda_lib.LAUNCHES["pack"] == before

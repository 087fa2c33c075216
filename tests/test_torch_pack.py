"""The visual pack's route and its wrapper (ops/pack_cuda.py) on the CPU.

`pack_cuda.takes`, the one predicate by which `infer.pack_visuals` runs
csrc/pack.cu instead of the eager composition, on each input it refuses; the
`cuda_lib.LAUNCHES["pack"]` count of `Relighter.forward_visuals` with the card
forced (the predicate sees a CUDA device; the launch runs `kernel_model`, a
plain model of the kernel's per-pixel arithmetic), one a call at every batch
size, and none off the card, nor in `forward` or the sweep's pack; the model
against the eager `pack_visuals` byte for byte on edge inputs (values on and
next to k/255 after the * 255, below 0 and above 1, fractional and zero masks,
a constant-depth image, -0.0, permuted albedo and rendered maps); and the
wrapper's checks, which run before any launch and refuse CPU tensors. The
kernel itself is held on the card (tests/test_torch_pack_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.infer import VISUAL_PACK_LAYOUT, Relighter, pack_visuals
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.ops import cuda_lib
from geomconsistentfr_torch.ops import pack_cuda as P
from geomconsistentfr_torch.render import RenderOutputs
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

S = 32
F32 = np.float32


def kernel_model(maps: list, dev=None) -> torch.Tensor:
    """csrc/pack.cu's arithmetic in numpy float32 (each operation correctly rounded, as the
    kernel's __f*_rn intrinsics): the range of -depth per image, each pixel's 12 values in
    the kernel's order, its bytes packed into three little-endian 32-bit words."""
    t = {name: x.numpy() for name, x, _ in maps}
    m = t["masks"]
    d = -t["depth"]
    dmin = d.min(axis=(1, 2), keepdims=True)
    dmax = d.max(axis=(1, 2), keepdims=True)
    span = np.fmax(dmax - dmin, F32(1e-12))

    def unit(x):
        q = np.fmin(np.fmax(x * F32(255.0), F32(0.0)), F32(255.0))
        return np.floor(q).astype(np.uint32)

    r = [unit(t["rendered"][..., c] * m) for c in range(3)]
    a = [unit(t["albedo"][..., c] * m) for c in range(3)]
    n = [unit((t["surface_normals"][..., c] + F32(1.0)) / F32(2.0) * m) for c in range(3)]
    shadow = unit(t["shadow_mask_weights"] * m)
    depth = unit((d - dmin) / span * m)
    shading = unit(t["final_shading"] * m)
    words = np.stack([r[0] | r[1] << 8 | r[2] << 16 | shadow << 24,
                      a[0] | a[1] << 8 | a[2] << 16 | depth << 24,
                      shading | n[0] << 8 | n[1] << 16 | n[2] << 24], axis=-1).astype("<u4")
    return torch.from_numpy(words.view(np.uint8).copy())


def model_pack(outputs, masks) -> torch.Tensor:
    return kernel_model(P._maps(outputs, masks))


def outputs_of(maps: dict) -> RenderOutputs:
    """RenderOutputs holding the pack's maps (the fields it does not read are None)."""
    return RenderOutputs(**{f: maps.get(f) for f in RenderOutputs._fields})


def random_maps(b, h, w, seed, permuted=False) -> tuple:
    """(outputs, masks) in the ranges the renderer gives, with binary masks; `permuted`:
    albedo and rendered as (B, H, W, 3) views of NCHW maps (render() leaves them contiguous;
    the kernel reads any strides)."""
    gen = torch.Generator().manual_seed(seed)

    def rgb(scale=1.0, shift=0.0):
        if permuted:
            return (torch.rand(b, 3, h, w, generator=gen) * scale + shift).permute(0, 2, 3, 1)
        return torch.rand(b, h, w, 3, generator=gen) * scale + shift

    maps = dict(rendered=rgb(1.3), albedo=rgb(), surface_normals=rgb(2.0, -1.0),
                shadow_mask_weights=torch.rand(b, h, w, generator=gen),
                depth=torch.randn(b, h, w, generator=gen) * 30.0 + 100.0,
                final_shading=torch.rand(b, h, w, generator=gen) * 1.5)
    masks = (torch.rand(b, h, w, generator=gen) > 0.3).float()
    return outputs_of(maps), masks


def edge_values(n: int, gen: torch.Generator) -> torch.Tensor:
    """n values drawn from the edges of the byte conversion: k/255 and its float32 neighbours
    (on and next to an integer after the * 255), below 0 and above 1, +-0.0."""
    k = torch.arange(256, dtype=torch.float32) / 255.0
    edges = torch.cat([k, torch.nextafter(k, torch.tensor(2.0)), torch.nextafter(k, torch.tensor(-1.0)),
                       torch.tensor([-0.0, 0.0, -1e-30, -0.5, -3.0, 1.0 + 1e-7, 1.5, 7.0, 255.0, 1e30])])
    return edges[torch.randint(len(edges), (n,), generator=gen)]


def edge_maps(b, h, w, seed, permuted=True) -> tuple:
    """(outputs, masks) of edge values; masks k/255, 0 and 1; image 0's depth constant (its
    range 0), image 1's all -0.0 and 0.0, image 2's within 1e-12 (the clamp of its range to
    1e-12 decides its depth bytes)."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return edge_values(int(np.prod(shape)), gen).view(*shape)

    def rgb():
        return draw(b, 3, h, w).permute(0, 2, 3, 1) if permuted else draw(b, h, w, 3)

    depth = draw(b, h, w) * 100.0
    depth[0] = 37.25
    if b > 1:
        depth[1] = torch.where(torch.rand(h, w, generator=gen) > 0.5, -0.0, 0.0)
    if b > 2:
        depth[2] = torch.tensor([0.0, 1e-13, 5e-13, 9e-13])[torch.randint(4, (h, w), generator=gen)]
    normals = draw(b, h, w, 3) * 2.0 - 1.0
    ends = torch.tensor([-1.0, -0.0, 0.0, 1.0, -1.0 - 1e-7, 1.0 + 1e-7, -3.0])[: normals.numel()]
    normals.view(-1)[: len(ends)] = ends
    maps = dict(rendered=rgb(), albedo=rgb(), surface_normals=normals, shadow_mask_weights=draw(b, h, w),
                depth=depth, final_shading=draw(b, h, w))
    masks = torch.randint(256, (b, h, w), generator=gen).float() / 255.0
    masks.view(-1)[: b * h * w // 4] = torch.tensor([0.0, 1.0, -0.0])[torch.randint(3, (b * h * w // 4,), generator=gen)]
    return outputs_of(maps), masks


def test_layout_is_the_kernels():
    """The kernel writes the layout's order: rendered, shadow, albedo, depth, shading, normals."""
    assert VISUAL_PACK_LAYOUT == (("rendered_image", 3), ("shadow_mask", 1), ("albedo", 3), ("depth", 1),
                                  ("shading", 1), ("surface_normals", 3))


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("shape", [(1, 32, 32), (3, 17, 23), (2, 1, 1), (2, 70, 65)])
def test_model_is_the_eager_pack_on_edge_inputs(shape, permuted):
    outputs, masks = edge_maps(*shape, seed=sum(shape), permuted=permuted)
    assert outputs.albedo.is_contiguous() is not permuted or shape[1] * shape[2] == 1
    want = pack_visuals(outputs, masks)
    got = model_pack(outputs, masks)
    assert got.dtype == torch.uint8 and got.shape == (*shape, 12)
    assert torch.equal(got, want)
    if masks.numel() >= 100:  # the draw reaches every kind of byte
        assert (want == 0).any() and (want == 255).any() and ((want > 0) & (want < 255)).any()


@pytest.mark.parametrize("seed", range(4))
def test_model_is_the_eager_pack_on_render_ranges(seed):
    outputs, masks = random_maps(2 + seed, 19 + seed, 31, seed, permuted=seed % 2 == 1)
    assert torch.equal(model_pack(outputs, masks), pack_visuals(outputs, masks))


def test_constant_depth_packs_zero_depth():
    """dmax - dmin is 0: the 1e-12 clamp keeps the division finite and the depth byte is 0."""
    outputs, masks = random_maps(2, 8, 8, 5)
    outputs = outputs._replace(depth=torch.full((2, 8, 8), 42.0))
    masks = torch.ones(2, 8, 8)
    got, want = model_pack(outputs, masks), pack_visuals(outputs, masks)
    assert torch.equal(got, want) and (want[..., 7] == 0).all()


def test_masked_out_pixels_pack_zero():
    outputs, masks = random_maps(2, 9, 9, 6)
    masks = torch.zeros(2, 9, 9)
    got = model_pack(outputs, masks)
    assert torch.equal(got, pack_visuals(outputs, masks)) and (got == 0).all()


# -- the route ------------------------------------------------------------------
def force_card(mp, seen: list) -> None:
    """Take the kernel's device condition as met on the CPU (every other check of `takes`
    still applies); each launch runs kernel_model and counts as the kernel's accepted launch
    would; `seen` receives each launch's maps."""
    def launch(maps, dev):
        seen.append(maps)
        cuda_lib.LAUNCHES["pack"] += 1
        return kernel_model(maps)

    mp.setattr(P, "_on_card", lambda dev: True)
    mp.setattr(P, "_launch", launch)


def relighter(variant="target"):
    presets = {"target": TC.preset_single_image, "transfer": TC.preset_lighting_transfer}
    cfg = TC.apply_precision_tier(presets[variant](), "high")
    r = cfg.render  # 16 samples of the preset's t grid, to keep the plain march cheap
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(r, img_height=S, img_width=S, num_sample_points=16,
                                                              t_stop=r.t_start + 15.5 * r.t_step))
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict()
    return Relighter(cfg, state, device="cpu")


def batch(b, seed=1):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    masks = (rng.random((b, S, S)) > 0.2).astype(np.float32)
    light = np.repeat(np.asarray([[0.3, 0.4, 0.87]], np.float32), b, 0)
    return imgs, masks, light


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_forward_visuals_launches_one_pack_with_the_card_forced(variant, b, monkeypatch):
    """One launch a forward_visuals at every batch size, on the render's own maps, giving the
    eager pack's bytes; none off the card."""
    rl = relighter(variant)
    imgs, masks, light = batch(b)
    cuda_lib.LAUNCHES["pack"] = 0
    want = rl.forward_visuals(imgs, masks, light)
    assert cuda_lib.LAUNCHES["pack"] == 0
    seen = []
    with monkeypatch.context() as mp:
        force_card(mp, seen)
        got = rl.forward_visuals(imgs, masks, light)
        assert cuda_lib.LAUNCHES["pack"] == 1
        got_again = rl.forward_visuals(imgs, masks, light)
        assert cuda_lib.LAUNCHES["pack"] == 2
    assert [name for name, _, _ in seen[0]] == ["rendered", "albedo", "surface_normals", "shadow_mask_weights",
                                                "depth", "final_shading", "masks"]
    assert got.shape == (b, S, S, 12) and torch.equal(got, want) and torch.equal(got_again, want)


def test_forward_and_the_sweep_launch_no_pack(monkeypatch):
    """Relighter.forward returns no pack, and the sweep's pack of the rendered image alone
    stays eager: neither launches the kernel, with the card forced."""
    rl = relighter()
    imgs, masks, light = batch(2)
    force_card(monkeypatch, [])
    cuda_lib.LAUNCHES["pack"] = 0
    rl.forward(imgs, masks, light)
    rl.relight_sweep_rendered_u8(imgs[0], masks[0], light)
    assert cuda_lib.LAUNCHES["pack"] == 0


def test_pack_visuals_on_the_cpu_is_eager(monkeypatch):
    outputs, masks = random_maps(2, 8, 8, 7)
    monkeypatch.setattr(P, "_launch", lambda *a: pytest.fail("the kernel was launched"))
    assert not P.takes(outputs, masks)
    pack_visuals(outputs, masks)


def replaced(outputs, masks, name, value):
    if name == "masks":
        return outputs, value
    return outputs._replace(**{name: value}), masks


MAP_NAMES = ["rendered", "albedo", "surface_normals", "shadow_mask_weights", "depth", "final_shading", "masks"]


def refusal_case(case):
    """(outputs, masks) of one refused input, and the wrapper's error and message."""
    outputs, masks = random_maps(2, 6, 5, 8, permuted=True)
    kind, _, name = case.partition(":")
    value = outputs.albedo if name == "albedo" else (masks if name == "masks" else getattr(outputs, name, None))
    if kind == "float64":
        return (*replaced(outputs, masks, name, value.double()), TypeError, "float32")
    if kind == "bfloat16":
        return (*replaced(outputs, masks, name, value.to(torch.bfloat16)), TypeError, "float32")
    if kind == "shape":
        return (*replaced(outputs, masks, name, value[:, :, :4]), ValueError, "shape")
    if kind == "device":
        return (*replaced(outputs, masks, name, value.to("meta")), ValueError, "expected cpu")
    if kind == "masks_2d":
        return outputs, masks[0], ValueError, r"\(B, H, W\)"
    if kind == "empty":
        empty = torch.zeros(2, 0, 5)
        return outputs, empty, ValueError, r"\(B, H, W\) with H and W positive"
    if kind == "batch":
        return (*replaced(outputs, masks, name, torch.cat([value, value])), ValueError, "shape")
    raise AssertionError(case)


REFUSALS = ([f"float64:{n}" for n in MAP_NAMES] + ["bfloat16:albedo", "bfloat16:masks"]
            + [f"shape:{n}" for n in MAP_NAMES] + ["device:rendered", "device:depth", "batch:surface_normals",
                                                  "masks_2d", "empty"])


@pytest.mark.parametrize("case", REFUSALS)
def test_takes_refuses_and_the_wrapper_raises_before_any_launch(case, monkeypatch):
    outputs, masks, error, match = refusal_case(case)
    monkeypatch.setattr(P, "_on_card", lambda dev: True)
    monkeypatch.setattr(P.LIBRARY, "load", lambda: pytest.fail("the launcher was reached"))
    monkeypatch.setattr(P, "_launch", lambda *a: pytest.fail("the kernel was launched"))
    assert P.takes(outputs, masks) is False
    with pytest.raises(error, match=match):
        P.pack(outputs, masks)


def test_takes_holds_on_agreeing_float32_maps_on_the_card(monkeypatch):
    outputs, masks = random_maps(2, 6, 5, 9, permuted=True)
    assert P.takes(outputs, masks) is False  # on the CPU
    monkeypatch.setattr(P, "_on_card", lambda dev: True)
    assert P.takes(outputs, masks) is True
    # Expanded and strided maps are read by their strides.
    expanded = masks[:1].expand(2, 6, 5)
    assert P.takes(outputs, expanded) is True


def test_cpu_tensors_raise_before_any_launch(monkeypatch):
    outputs, masks = random_maps(2, 6, 5, 10)
    monkeypatch.setattr(P.LIBRARY, "load", lambda: pytest.fail("the launcher was reached"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.pack(outputs, masks)


def test_launch_hands_the_launcher_every_map_by_its_strides(monkeypatch):
    """The wrapper's call: the seven maps' pointers in the launcher's order, their 24 strides,
    a scratch of 64 floats an image, the (B, H, W, 12) uint8 output, B, H, W."""
    outputs, masks = random_maps(3, 6, 5, 11, permuted=True)
    calls = []
    monkeypatch.setattr(P.LIBRARY, "launch", lambda kernel, dev, *args: calls.append((kernel, dev, args)))
    out = P._launch(P._maps(outputs, masks), torch.device("cpu"))
    (kernel, dev, args), = calls
    maps = [outputs.rendered, outputs.albedo, outputs.surface_normals, outputs.shadow_mask_weights, outputs.depth,
            outputs.final_shading, masks]
    assert kernel == "pack" and dev == torch.device("cpu")
    assert list(args[:7]) == [t.data_ptr() for t in maps]
    assert list(args[7]) == [s for t in maps for s in t.stride()]
    assert outputs.albedo.stride()[3] == 6 * 5  # a permuted NCHW map: channel stride H * W
    assert args[9] == out.data_ptr() and out.shape == (3, 6, 5, 12) and out.dtype == torch.uint8
    assert out.is_contiguous() and args[10:] == (3, 6, 5)

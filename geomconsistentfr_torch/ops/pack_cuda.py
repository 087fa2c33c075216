"""Build, bind and launch the uint8 visual pack (csrc/pack.cu).

`pack(outputs, masks)` is `infer.pack_visuals` in one launch of the
library: the (B, H, W, 12) uint8 tensor of `infer.VISUAL_PACK_LAYOUT`, byte
for byte the eager composition's for finite inputs. It reads the render
outputs by their element strides (render() leaves them contiguous; a
permuted, strided or expanded view is read as it is), so no copy is made,
and raises before any launch on what the kernel does not read.

`takes` is the one predicate by which `infer.pack_visuals` runs the kernel
instead of the eager composition, which stays the plain version off the
card. `LIBRARY` declares the kernel to ops/cuda_lib.py, which builds and
launches it and counts its launches as 'pack' (one a pack, whatever the
batch: the launcher runs the per-image depth range and the pack in turn).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from geomconsistentfr_torch.ops.cuda_lib import Library

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library(Path(__file__).resolve().parents[1] / "csrc" / "pack.cu", {
    "pack": ("gcfr_pack_launch", [_c_void_p] * 10 + [_c_int] * 3),
})

# The render outputs the pack reads, (B, H, W, 3) maps first, in the launcher's order.
CHANNEL_MAPS = ("rendered", "albedo", "surface_normals")
PLANE_MAPS = ("shadow_mask_weights", "depth", "final_shading")
# Floats of the launcher's scratch an image: each range block's minimum and maximum.
SCRATCH_FLOATS = 64


def _maps(outputs, masks) -> list:
    """(name, tensor, expected shape) of every map the kernel reads, in the launcher's order."""
    shape = tuple(masks.shape)
    return ([(n, getattr(outputs, n), shape + (3,)) for n in CHANNEL_MAPS]
            + [(n, getattr(outputs, n), shape) for n in PLANE_MAPS] + [("masks", masks, shape)])


def _refusal(outputs, masks):
    """Why the kernel does not pack `outputs` with `masks`, as the exception to raise; None
    where it does."""
    if masks.dim() != 3 or masks.shape[1] == 0 or masks.shape[2] == 0:
        return ValueError(f"the masks must be (B, H, W) with H and W positive, got {tuple(masks.shape)}")
    dev = masks.device
    for name, t, shape in _maps(outputs, masks):
        if t.device != dev:
            return ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            return TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            return ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not _on_card(dev):
        return ValueError(f"the pack kernel runs on CUDA tensors, got {dev}")
    return None


def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def takes(outputs, masks) -> bool:
    """Whether the kernel packs `outputs` with `masks`: CUDA float32 tensors on one device,
    the masks (B, H, W) with H and W positive, the rendered image, albedo and normals
    (B, H, W, 3), the shadow weights, depth and final shading (B, H, W)."""
    return _refusal(outputs, masks) is None


def pack(outputs, masks) -> torch.Tensor:
    """The uint8 (B, H, W, 12) visual pack of `outputs` under `masks`; raises, before any
    launch, where `takes` does not hold."""
    refusal = _refusal(outputs, masks)
    if refusal is not None:
        raise refusal
    return _launch(_maps(outputs, masks), masks.device)


def _launch(maps: list, dev: torch.device) -> torch.Tensor:
    b, h, w = maps[-1][1].shape
    strides = (ctypes.c_longlong * 24)(*(s for _, t, _ in maps for s in t.stride()))
    scratch = torch.empty((b, SCRATCH_FLOATS), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, w, 12), dtype=torch.uint8, device=dev)
    LIBRARY.launch("pack", dev, *(t.data_ptr() for _, t, _ in maps), strides, scratch.data_ptr(), out.data_ptr(),
                   b, h, w)
    return out

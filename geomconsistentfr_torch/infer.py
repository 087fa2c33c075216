"""Inference: batched relighting, light sweeps, lighting transfer.

Port of geomconsistentfr_tpu/infer.py:48-551:
  * `Relighter.forward`           -- batched relighting with explicit targets.
  * `Relighter.forward_visuals`   -- the same, packed into uint8 visuals.
  * `Relighter.relight_sweep`     -- one network forward, the renderer over L lights.
  * `Relighter.estimate_lighting` / `transfer_lighting` -- the 2-pass protocol.
  * `Relighter.relight_frames`    -- uncropped frames: S3FD at batch, the
    reference's crop of the largest face and its mask, `forward_visuals`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
card and no explicit CPU request they raise. Inputs may be numpy arrays or
tensors: images (B, H, W, 3) and masks (B, H, W), float32 in [0, 1] or uint8
(divided by 255 on the device). Outputs are tensors on the Relighter's device.

With a `mesh` (parallel/mesh.py) every rank calls the same entry point with
the same global inputs and gets the same global outputs; `parallel` picks
what the ranks split:
  * 'data' (throughput): each rank runs its slice of the batch (B a
    multiple of the mesh size), the outputs are gathered over every rank.
    forward, forward_visuals and estimate_lighting; sweeps run unsharded.
  * 'samples' (latency; a 1-D mesh): the batch and the CNN are replicated
    and each rank marches its contiguous slice of the t grid
    (ops/shadows.sharded_sample_ts), MIN-combined over the mesh
    (ops/shadows_cuda.sharded_march). The MIN is exact and every step after
    it is per pixel, so the outputs are bit-equal to one process's. At the
    draft tier the slices come from the scaled config (its strided grid),
    the argmin march combines its winning t too, in the same MIN (K2's
    packed (distance, t) keys, one collective), and the refine runs
    replicated on every rank. forward, forward_visuals, relight_sweep*.
  * 'grid' (a 2-D (data, samples) mesh): the batch shards over the data
    axis (B a multiple of its size) and the march over the samples axis;
    sweeps replicate over the data axis.
"""

from __future__ import annotations

import functools
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from geomconsistentfr_torch.config import PipelineConfig, preset_lighting_transfer
from geomconsistentfr_torch.convert import (
    is_transfer_state,
    load_checkpoint,
    state_dict_from_jax_variables,
    transfer_to_target_variant,
)
from geomconsistentfr_torch.models.layers import deterministic_convs
from geomconsistentfr_torch.models.relightnet import FULL_SKIPS, RelightNet
from geomconsistentfr_torch.ops import pack_cuda, shadows
from geomconsistentfr_torch.ops.shadows_cuda import refine_min_distance_cuda, sharded_march
from geomconsistentfr_torch.parallel.mesh import Mesh, all_gather_cat
from geomconsistentfr_torch.render import RenderOutputs, estimated_light, render
from geomconsistentfr_torch.utils.checkpoint import restore_variables
from geomconsistentfr_torch.utils.profiling import count, span

# Channel layout of the packed uint8 visualization tensor (B, H, W, 12).
VISUAL_PACK_LAYOUT = (
    ("rendered_image", 3),
    ("shadow_mask", 1),
    ("albedo", 3),
    ("depth", 1),
    ("shading", 1),
    ("surface_normals", 3),
)


def resolve_device(device=None) -> torch.device:
    """`device`, or `cuda` when none is given; raises when CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def _to_unit(q: torch.Tensor) -> torch.Tensor:
    """floor(clip(x * 255)) as uint8 (numpy's float->uint8 truncation)."""
    return torch.floor(torch.clamp(q * 255.0, 0.0, 255.0)).to(torch.uint8)


def pack_visuals(outputs: RenderOutputs, masks: torch.Tensor) -> torch.Tensor:
    """The six eval visualizations fused into one uint8 (B, H, W, 12) tensor: csrc/pack.cu's
    one launch where `pack_cuda.takes` holds (CUDA float32 maps), else this composition,
    its plain version."""
    if pack_cuda.takes(outputs, masks):
        return pack_cuda.pack(outputs, masks)
    m1 = masks[..., None]
    d = -outputs.depth
    dmin = d.amin(dim=(1, 2), keepdim=True)
    dmax = d.amax(dim=(1, 2), keepdim=True)
    depth_vis = (d - dmin) / torch.clamp(dmax - dmin, min=1e-12)
    packed = torch.cat(
        [
            outputs.rendered * m1,
            (outputs.shadow_mask_weights * masks)[..., None],
            outputs.albedo * m1,
            (depth_vis * masks)[..., None],
            (outputs.final_shading * masks)[..., None],
            (outputs.surface_normals + 1.0) / 2.0 * m1,
        ],
        dim=-1,
    )
    return _to_unit(packed)


class FramesRelit(NamedTuple):
    """`Relighter.relight_frames`' result: the relit crops' packed uint8 visuals (N, S, S, 12)
    on the Relighter's device, the index of each crop's frame (N,), per frame its kept S3FD
    boxes (K, 5) [x1, y1, x2, y2, score] in the frame's coordinates, and the candidate rows the
    boxes came from (preprocess.S3FDBatch.candidates)."""

    visuals: torch.Tensor
    frame_index: np.ndarray
    boxes: List[np.ndarray]
    candidates: np.ndarray


def _host_array(x) -> np.ndarray:
    """A numpy array of `x` on the host: a CPU tensor's own memory, a device tensor's copy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy() if x.device.type != "cpu" else x.numpy()
    return np.asarray(x)


class AsyncFetch:
    """A device result's copy to the host, started at once and waited for later.

    The counterpart of JAX's `copy_to_host_async` for the pipelined server and
    the evaluation's dump. Create it before dispatching the work (on CUDA it
    records an event there), pass the result to `copy`, and call `wait()`
    when the host needs it. On CUDA, `copy` puts the tensor into pinned host
    memory with `non_blocking=True` on the current stream and records a
    second event, so the host returns at once and can assemble the next
    batch while the card computes; `wait()` synchronises on that event and
    gives the array and the device's seconds from the first event to the
    copy's end. On the CPU the work has finished when `copy` is called, and
    the seconds are the host's clock around it.
    """

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.monotonic()

    def copy(self, x: torch.Tensor) -> "AsyncFetch":
        if self._cuda:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._done = torch.cuda.Event(enable_timing=True)
            self._done.record()
        else:
            self._host = x
            self._seconds = time.monotonic() - self._t0
        return self

    def wait(self) -> Tuple[np.ndarray, float]:
        """(the result as a numpy array, the device's seconds)."""
        if self._cuda:
            self._done.synchronize()
            return self._host.numpy(), self._start.elapsed_time(self._done) / 1e3
        return self._host.numpy(), self._seconds


class Relighter:
    """RelightNet + the renderer, on one device or over a mesh of ranks (module docstring)."""

    def __init__(
        self,
        cfg: PipelineConfig,
        state_dict,
        use_skips: Tuple[bool, bool, bool, bool] = FULL_SKIPS,
        device=None,
        mesh: Optional[Mesh] = None,
        parallel: str = "data",
    ):
        if parallel not in ("data", "samples", "grid"):
            raise ValueError(f"unknown parallel mode: {parallel!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.parallel = parallel
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.use_skips = tuple(use_skips)
        self.model = RelightNet(cfg.model, device=self.device)
        self.model.load_state_dict(state_dict)
        self.model.eval()
        # The group the batch shards over, and the march over the sample shards.
        self._batch_group, self._march_fn = None, None
        if mesh is None:
            return
        if parallel == "data":
            self._batch_group = mesh.world_group
            return
        if parallel == "grid":
            if len(mesh.axis_names) != 2:
                raise ValueError("parallel='grid' needs a 2-D (data, samples) mesh; see parallel.mesh.make_mesh_grid")
            data_axis, axis = mesh.axis_names
            self._batch_group = mesh.group(data_axis)
        else:
            if len(mesh.axis_names) != 1:
                raise ValueError("parallel='samples' expects a 1-D mesh; use parallel='grid' for a 2-D (data, samples) mesh")
            axis = mesh.axis_names[0]
        self._march_fn = self._sharded_march_fn(mesh.group(axis), mesh.axis_size(axis), mesh.axis_index(axis))

    def _sharded_march_fn(self, group, n_shards: int, shard: int):
        """render()'s march_fn: this rank's t slice, combined over `group`; the draft refine replicated."""
        rcfg = self.cfg.render
        # The draft tier marches pooled inputs over the scaled config's strided
        # t grid, so its slices come from that grid.
        mcfg = shadows.scaled_render_cfg(rcfg) if rcfg.shadow_resolution_scale > 1 else rcfg
        ts = shadows.sharded_sample_ts(mcfg, n_shards).reshape(n_shards, -1)[shard]
        ts_local = torch.as_tensor(ts, device=self.device)

        def march(depth, mask, light_point, return_argmin_t=False):
            return sharded_march(depth, mask, light_point, mcfg, ts_local, group, return_argmin_t)

        # Every rank refines the whole window: the outputs are the same
        # everywhere, so no combine is needed (JAX infer.py:314-329).
        march.refine_fn = functools.partial(refine_min_distance_cuda, cfg=rcfg)
        return march

    def _as_input(self, x, part=slice(None)) -> torch.Tensor:
        """Tensor on the device (of the rows `part`); uint8 is divided by 255 there, else float32."""
        x = torch.as_tensor(x)[part]
        if x.dtype == torch.uint8:
            return x.to(self.device).float() / 255.0
        return x.to(self.device, torch.float32)

    def _check_batch(self, b: int) -> None:
        if self._batch_group is None:
            return  # no mesh, or the batch replicated: any size works
        n = self.mesh.size if self.parallel == "data" else self.mesh.axis_size(self.mesh.axis_names[0])
        if b % n:
            what = f"the grid mesh's batch-axis size {n}" if self.parallel == "grid" else f"the mesh size {n}"
            raise ValueError(f"batch size {b} must be a multiple of {what} (pad the tail batch)")

    def _part(self, b: int) -> slice:
        """This rank's rows of a batch of b."""
        if self._batch_group is None:
            return slice(None)
        if self.parallel == "data":
            per = b // self.mesh.size
            return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)
        return self.mesh.batch_slice(b)

    def _targets(self, b, target_light, target_ambient, part):
        if target_light is None:
            target_light = torch.zeros((b, 3))
        if target_ambient is None:
            target_ambient = torch.zeros((b,))
        return (
            torch.as_tensor(target_light)[part].to(self.device, torch.float32),
            torch.as_tensor(target_ambient)[part].to(self.device, torch.float32),
        )

    def _forward_local(self, images, masks, target_light, target_ambient):
        """This rank's rows: (RenderOutputs, its masks)."""
        b = torch.as_tensor(images).shape[0]
        self._check_batch(b)
        part = self._part(b)
        with span("gcfr.upload"):
            images, masks = self._as_input(images, part), self._as_input(masks, part)
            light, ambient = self._targets(b, target_light, target_ambient, part)
        net = self._net(images)
        out = render(net.albedo, net.depth, net.lighting, masks, self.cfg.render,
                     target_light=light, target_ambient=ambient, march_fn=self._march_fn)
        return out, masks

    def _net(self, images):
        """RelightNet's forward, with cuDNN's deterministic algorithms: in
        float32 cuDNN's default choice adds in an order that changes from call
        to call (on an H100 at batch 1, a few bytes of the uint8 visual pack
        moved by one level between calls and between processes), and ranks
        that replicate the CNN around a sharded march must march the same
        depth bits."""
        with span("gcfr.cnn"), deterministic_convs():
            return self.model(images, self.use_skips)

    @torch.no_grad()
    def forward(self, images, masks, target_light=None, target_ambient=None) -> RenderOutputs:
        """Relight a batch: images (B, H, W, 3), masks (B, H, W), target_light (B, 3)."""
        out, _ = self._forward_local(images, masks, target_light, target_ambient)
        return RenderOutputs(*(all_gather_cat(x, self._batch_group) for x in out))

    @torch.no_grad()
    def forward_visuals(self, images, masks, target_light=None, target_ambient=None) -> torch.Tensor:
        """`forward`, returned as the packed uint8 (B, H, W, 12) visuals."""
        out, masks = self._forward_local(images, masks, target_light, target_ambient)
        with span("gcfr.pack"):
            packed = pack_visuals(out, masks)
        return all_gather_cat(packed, self._batch_group)

    @torch.no_grad()
    def relight_sweep(self, image, mask, lights, ambients=None) -> RenderOutputs:
        """One image (H, W, 3), L target lights (L, 3) -> outputs with leading axis L."""
        with span("gcfr.upload"):
            lights = torch.as_tensor(lights).to(self.device, torch.float32)
            n = lights.shape[0]
            if ambients is None:
                ambients = torch.full((n,), 0.5)
            ambients = torch.as_tensor(ambients).to(self.device, torch.float32)
            image, mask = self._as_input(image), self._as_input(mask)
        net = self._net(image[None])

        def tile(x):
            return x.expand(n, *x.shape[1:])

        return render(tile(net.albedo), tile(net.depth), tile(net.lighting),
                      mask[None].expand(n, *mask.shape), self.cfg.render,
                      target_light=lights, target_ambient=ambients, march_fn=self._march_fn)

    @torch.no_grad()
    def relight_sweep_rendered_u8(self, image, mask, lights, ambients=None) -> torch.Tensor:
        """Sweep returning only the masked uint8 renders (L, H, W, 3)."""
        out = self.relight_sweep(image, mask, lights, ambients)
        with span("gcfr.pack"):
            return _to_unit(out.rendered * self._as_input(mask)[None, ..., None])

    @torch.no_grad()
    def estimate_lighting(self, images):
        """Estimated (unit direction (B, 3), ambient (B,)), z clamped per the config,
        from RelightNet's encoder and lighting head (`RelightNet.estimate`): no decoder runs.

        Sharded in 'data' mode only: the samples and grid modes shard the
        march, which this skips, so any batch size works there.
        """
        b = torch.as_tensor(images).shape[0]
        group = self._batch_group if self.parallel == "data" else None
        part = slice(None)
        if group is not None:
            self._check_batch(b)
            part = self._part(b)
        with span("gcfr.upload"):
            images = self._as_input(images, part)
        # The encoder and the lighting head alone, under _net's deterministic convolutions.
        with span("gcfr.cnn"), deterministic_convs():
            lighting = self.model.estimate(images)
        unit, ambient = estimated_light(lighting, self.cfg.render)
        return all_gather_cat(unit, group), all_gather_cat(ambient, group)

    @torch.no_grad()
    def relight_frames(self, frames, mask_frames, detector, target_light, target_ambient=None) -> FramesRelit:
        """Detect, crop and relight uncropped frames (recrop_CelebA-HQ_images.py, then the relight).

        frames (B, H, W, 3) uint8 RGB and mask_frames (B, H, W) uint8: numpy, or tensors on the
        host (pinned or not) or on the device; detector: an S3FD on this Relighter's device;
        target_light (B, 3) and target_ambient (B,) (or None) per frame. S3FD runs at batch B
        (preprocess.detect_s3fd_batch). Each frame's largest kept box is cropped from the
        frame and from its mask frame on the host, with crop_largest_face's geometry and bytes
        (span gcfr.crop), at the render's size; `forward_visuals` relights the crops under the
        lights of the frames that gave one. A frame with no box, or whose box scales below the
        crop's 200 px minimum, gives no row (counted as crop.skipped).
        """
        from geomconsistentfr_torch import preprocess

        boxes, candidates = preprocess.detect_s3fd_batch(frames, detector)
        size = self.cfg.render.img_height
        with span("gcfr.crop"):
            images, masks = _host_array(frames), _host_array(mask_frames)
            crops, mask_crops, index = [], [], []
            for b, det in enumerate(boxes):
                box = preprocess.largest_box([tuple(float(v) for v in d[:4]) for d in det])
                crop = None if box is None else preprocess.crop_face(images[b], box, size)
                if crop is not None:
                    crops.append(crop)
                    mask_crops.append(preprocess.crop_face(masks[b], box, size))
                    index.append(b)
            count("crop.skipped", len(boxes) - len(index))
        index = np.asarray(index, np.int64)
        if not len(index):
            return FramesRelit(torch.empty((0, size, size, 12), dtype=torch.uint8, device=self.device), index, boxes,
                               candidates)

        def of_crops(x):
            x = torch.as_tensor(x)
            return x[torch.from_numpy(index).to(x.device)]

        visuals = self.forward_visuals(np.stack(crops), np.stack(mask_crops), target_light=of_crops(target_light),
                                       target_ambient=None if target_ambient is None else of_crops(target_ambient))
        return FramesRelit(visuals, index, boxes, candidates)

    def transfer_lighting(self, input_images, reference_images, masks) -> RenderOutputs:
        """2-pass lighting transfer: estimate from `reference`, render `input`."""
        unit, ambient = self.estimate_lighting(reference_images)
        return self.forward(input_images, masks, target_light=unit, target_ambient=ambient)


def load_relighter(
    checkpoint_path: str,
    cfg: Optional[PipelineConfig] = None,
    use_skips: Tuple[bool, bool, bool, bool] = FULL_SKIPS,
    device=None,
    mesh: Optional[Mesh] = None,
    parallel: str = "data",
) -> Relighter:
    """Build a Relighter from a reference `.pth` state dict or an orbax
    checkpoint directory of flax variables (what the JAX package's
    `save_variables` and either package's `cli convert` write).

    Transfer-variant weights embed exactly into the target variant, so a
    'target' config takes a transfer checkpoint as it is.
    """
    if cfg is None:
        cfg = preset_lighting_transfer()
    if os.path.isdir(checkpoint_path):
        state = state_dict_from_jax_variables(restore_variables(checkpoint_path))
    else:
        state = load_checkpoint(checkpoint_path)
    if cfg.model.variant == "target" and is_transfer_state(state):
        state = transfer_to_target_variant(state)
    return Relighter(cfg, state, use_skips=use_skips, device=device, mesh=mesh, parallel=parallel)

"""Build, bind and launch the CUDA shadow-march kernels (csrc/march.cu).

The wrappers, one per kernel:
  * `ray_march_min_distance_cuda` launches K1 ('march'), or K2
    ('march_argmin') with `return_argmin_t`;
  * `refine_min_distance_cuda` launches K3 ('refine') around a full-
    resolution t_map, `refine_around_argmin_cuda` K3 around K2's winning
    indices (no t_map in memory);
  * `draft_march` is the draft tier's march with the refine on: three
    launches, one staging pass (the pooled and the full-resolution inputs,
    both resolutions' cull flags, the scaled light), K2 at low resolution,
    then K3 around K2's winners;
  * `pool_march_inputs` is the draft pooling alone, on the same staging
    kernel, for the draft paths whose pooled inputs go to another march;
  * `march_grad_cuda` launches the backward of K4 ('march_grad') on the
    forward's staged input, at K2's winning indices; `march_grad_at_cuda`
    the same kernel at a per-pixel t map (K5's backward);
  * `unpack_march_key` launches the unpack of K2's packed (distance, t) keys
    ('unpack_key').
For a CUDA tensor a wrapper launches its kernel (or raises); for a CPU tensor
it runs the plain version of ops/shadows.py. There is no other fallback.
K1-K3 read depth and mask interleaved and padded, (B, H + 1, W + 1, 2),
which a staging launch writes first (csrc/march.cu stage_kernel, counted as
'stage', into tensors the wrapper allocates; `shadows.stage_inputs` is its
plain version). K2 and the draft path's K3 cull from the flags the staging
writes, K1 and K3 around a t_map from the mask inside the kernel. Each
kernel is compiled for every veto (`shadows.VETOES`; one function holds the
one-hot and the bilinear veto) and for each form of its taps: where the
offsets t leave [0, 1] or H or W exceeds QUAD_MAX,
the wrapper launches the clamped form, whose taps are clamped to the image
one by one as the plain version's are (csrc/march.cu, the range); the
preset tables at the preset sizes take the quad form. H and W need only be
those RenderConfig admits.

`RayMarchMinDistance` is the differentiable march K4 (the JAX package's
`ray_march_min_distance_pallas_vjp`): its forward is K2, its backward
march_grad at K2's winning samples; on CPU tensors the plain argmin march and
the plain `shadows.march_vjp`. `ray_march_min_distance_cuda` goes through it
whenever depth or the light point needs a gradient.

The sample-sharded paths, where each rank of a process group marches a
contiguous slice of the t grid (`shadows.sharded_sample_ts`):
  * `sharded_march` serves (`Relighter(parallel='samples'|'grid')`): K1 on
    the slice then the MIN over the group, or with `return_argmin_t` K2's
    key form on the slice, one MIN of the keys and the unpack;
  * `RayMarchMinDistanceSP` is K5, the JAX package's
    `ray_march_min_distance_pallas_vjp_sp` (the grid train step): K2's key
    form on the slice (counted as 'march_sp'), one MIN of the keys over the
    group, the unpack, then march_grad at the global winner's t, replicated
    on every rank with no collective of its own.
K2's key form packs each pixel's (distance, winning t) into one int64 whose
signed order is their lexicographic order (`shadows.pack_march_key`), so
the one MIN is the reference's two pmins: the global minimum, then the
smallest t among the ranks that reach it (shadows_pallas.py:851-855). The
MIN is a collective of torch.distributed outside the kernels, as `pmin` is
outside the Pallas kernel.

`LIBRARY` declares csrc/march.cu's kernels to ops/cuda_lib.py, which builds,
loads and launches them and counts each launch under the kernel's name in
`cuda_lib.LAUNCHES`: 'stage', 'march', 'march_argmin', 'refine',
'march_grad', 'march_sp' and 'unpack_key'.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from geomconsistentfr_torch.config import RenderConfig
from geomconsistentfr_torch.ops import shadows
from geomconsistentfr_torch.ops.cuda_lib import Library, check, ptr
from geomconsistentfr_torch.parallel.mesh import all_min

# The kernel's `form` argument (csrc/march.cu, enum Form).
_FORMS = {"march": 0, "march_argmin": 1, "refine": 2}
# The largest H and W of the kernels' quad form (csrc/march.cu, the range).
QUAD_MAX = 2048

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MARCH = ("gcfr_march_launch", [_c_int] + [_c_void_p] * 11 + [_c_int] * 11 + [_c_float] * 7)
LIBRARY = Library(Path(__file__).resolve().parents[1] / "csrc" / "march.cu", {
    "stage": ("gcfr_stage_launch", [_c_void_p] * 8 + [_c_int] * 6),
    "march": _MARCH, "march_argmin": _MARCH, "refine": _MARCH,
    "march_grad": ("gcfr_march_grad_launch", [_c_void_p] * 9 + [_c_int] * 5),
    "march_sp": _MARCH,  # K2's key form on a rank's slice, launched as 'march_argmin' (count_as)
    "unpack_key": ("gcfr_unpack_key_launch", [_c_void_p] * 3 + [ctypes.c_longlong]),
})


def _in_unit(lo: float, hi: float) -> bool:
    """Offsets from lo to hi lie in [0, 1], between the pixel and the border (False for a NaN)."""
    return 0.0 <= lo and hi <= 1.0


def _clamp(h: int, w: int, in_unit: bool) -> bool:
    """The kernels' clamped taps: where t leaves [0, 1] or H or W exceeds QUAD_MAX (csrc/march.cu, the range)."""
    return not in_unit or max(h, w) > QUAD_MAX


@functools.lru_cache(maxsize=16)
def _grid(t_start: float, t_stop: float, t_step: float, n: int) -> tuple:
    """(the config's float32 t table on the host, its least and greatest offset)."""
    ts = shadows.sample_ts(RenderConfig(t_start=t_start, t_stop=t_stop, t_step=t_step, num_sample_points=n))
    ts = ts.astype(np.float32)
    return ts, float(ts.min()), float(ts.max())


def _grid_of(cfg: RenderConfig) -> tuple:
    return _grid(cfg.t_start, cfg.t_stop, cfg.t_step, cfg.num_sample_points)


def _grid_clamp(cfg: RenderConfig) -> bool:
    """Whether the kernels take the config's own grid with clamped taps (known on the host)."""
    _, lo, hi = _grid_of(cfg)
    return _clamp(cfg.img_height, cfg.img_width, _in_unit(lo, hi))


@functools.lru_cache(maxsize=16)
def _ts_on(device: torch.device, t_start: float, t_stop: float, t_step: float, n: int) -> torch.Tensor:
    return torch.as_tensor(_grid(t_start, t_stop, t_step, n)[0], device=device)


def _range(ts: torch.Tensor) -> tuple:
    """(least, greatest) of a 1-D table, (inf, -inf) when empty; on a CUDA tensor this waits for the card."""
    if not ts.numel():
        return float("inf"), float("-inf")
    lo, hi = ts.aminmax()
    return lo.item(), hi.item()


@functools.lru_cache(maxsize=16)
def _offsets_on(device: torch.device, halfwidth: int, t_step: float) -> torch.Tensor:
    cfg = RenderConfig(t_step=t_step, shadow_refine_halfwidth=halfwidth)
    return torch.as_tensor(shadows.refine_offsets(cfg), device=device)


def needs_grad(depth: torch.Tensor, light_point: torch.Tensor) -> bool:
    """True when autograd records and depth or the light point asks for a gradient."""
    return torch.is_grad_enabled() and (depth.requires_grad or light_point.requires_grad)


def _check_inputs(depth, mask, light_point, cfg: RenderConfig, what: str) -> None:
    """Device, the config's shape (which RenderConfig has checked), float32, contiguous."""
    if depth.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got {depth.device}")
    b, h, w = depth.shape
    if (h, w) != (cfg.img_height, cfg.img_width):
        raise ValueError(f"depth {tuple(depth.shape)} does not match the config's {cfg.img_height}x{cfg.img_width}")
    check("depth", depth, (b, h, w), depth.device)
    check("mask", mask, (b, h, w), depth.device)
    check("light_point", light_point, (b, 3), depth.device)


def _stage(depth, mask, light_point, cfg: RenderConfig, draft: bool = False, flags: bool = False,
           full_res: bool = True) -> shadows.Staged:
    """stage_kernel, one launch: shadows.stage_inputs on the card.

    Without `draft` it stages at full resolution (s = 1) whatever the
    config's scale; with it, at the draft scale s, also the scaled light and,
    with `full_res`, the full-resolution quad. With `flags` and the config's
    cull, the cull flags of each quad written.
    """
    b, h, w = depth.shape
    dev = depth.device
    s = cfg.shadow_resolution_scale if draft else 1
    if h % s or w % s:
        raise ValueError(f"the staging needs H and W divisible by the scale {s}; got {h}x{w}")
    m_cfg = shadows.scaled_render_cfg(cfg) if s > 1 else cfg
    cull = flags and cfg.shadow_mask_cull
    chunk, full_chunk = shadows.effective_col_chunk(m_cfg), shadows.effective_col_chunk(cfg)
    if cull and ((w // s) % chunk or w % full_chunk):
        raise ValueError(f"cull blocks need the width divisible by the chunk; got W={w}, C={full_chunk}, s={s}")
    if depth.data_ptr() % 16 or mask.data_ptr() % 16:
        raise ValueError("the staging reads depth and mask in 16-byte vectors: they must be 16-byte aligned")
    quad = torch.empty((b, h // s + 1, w // s + 1, 2), dtype=torch.float32, device=dev)
    live = torch.empty((b, -(-h // s // 8), w // s // chunk), dtype=torch.uint8, device=dev) if cull else None
    full_res = full_res and s > 1
    full = torch.empty((b, h + 1, w + 1, 2), dtype=torch.float32, device=dev) if full_res else None
    full_live = torch.empty((b, -(-h // 8), w // full_chunk), dtype=torch.uint8, device=dev) if cull and full_res else None
    light = torch.empty((b, 3), dtype=torch.float32, device=dev) if s > 1 else None
    LIBRARY.launch("stage", dev, depth.data_ptr(), mask.data_ptr(), light_point.data_ptr(), quad.data_ptr(),
                   ptr(full), ptr(live), ptr(full_live), ptr(light), b, h, w, s, chunk, full_chunk)
    return shadows.Staged(quad, live, full, full_live, light)


def pool_march_inputs(depth, mask, light_point, cfg: RenderConfig):
    """shadows.scale_march_inputs, the draft tier's pooling, where the pooled
    inputs go on to another march (sample and grid parallelism, and
    shadow_refine_halfwidth 0): on CUDA tensors the draft staging's pooling
    (one stage_kernel launch, no full-resolution quad) and one copy out of
    its quad (shadows.unpad_quad), the same floats; on CPU tensors the plain
    version.
    """
    if depth.device.type == "cpu":
        return shadows.scale_march_inputs(depth, mask, light_point, cfg)
    _check_inputs(depth, mask, light_point, cfg, "draft pooling")
    staged = _stage(depth, mask, light_point, cfg, draft=True, full_res=False)
    return (*shadows.unpad_quad(staged.quad), staged.light, shadows.scaled_render_cfg(cfg))


def _launch(kernel: str, staged: shadows.Staged, mask, light_point, ts, cfg: RenderConfig, t_map=None, centre=None,
            idx=None, key=None, count_as=None, clamp: Optional[bool] = None):
    """Launch one form of the march kernel on a staged quad, on the current stream; (B, H, W)
    distances, or with `key` (K2's key form) the int64 keys it wrote.

    staged: the quad and flags of the march's grid (staged.quad, .flags);
    without flags the kernel culls from `mask`, which may be None where the
    config does not cull. K3's centre is `t_map`, or `centre` = (K2's int32
    index (B, H/s, W/s), the float32 table it indexes). clamp: K1 and K2
    take `ts` with clamped taps, as _ts_for tells with the table (_clamp);
    K3's t range is the config's, so its launch tells that itself. The
    launch counts under `count_as`, by default the form's own name.
    """
    quad, flags = staged.quad, staged.flags
    b, h, w = quad.shape[0], quad.shape[1] - 1, quad.shape[2] - 1
    dev = quad.device
    veto = shadows.VETOES.index(shadows.resolve_mask_gather(cfg))
    chunk = shadows.effective_col_chunk(cfg)
    if cfg.shadow_mask_cull and w % chunk:
        raise ValueError(f"cull blocks need W % C == 0; got W={w}, C={chunk}")
    if cfg.shadow_mask_cull and flags is None and mask is None:
        raise ValueError("the cull needs the staging's flags or the mask")
    bounds = shadows.gate_bounds(cfg)
    gate_on = bounds is not None
    lo_x, hi_x, lo_y, hi_y = bounds if gate_on else (0.0, 0.0, 0.0, 0.0)
    t_lo, t_hi = shadows.refine_t_range(cfg) if kernel == "refine" else (0.0, 0.0)
    if kernel == "refine":
        clamp = _clamp(h, w, _in_unit(t_lo, t_hi))
    elif clamp is None:
        raise TypeError(f"the {kernel} launch needs the clamp that _ts_for gives with its table")
    centre_idx, centre_ts = centre if centre is not None else (None, None)

    out = torch.empty((b, h, w), dtype=torch.float32, device=dev) if key is None else None
    LIBRARY.launch(
        kernel, dev, _FORMS[kernel], quad.data_ptr(), ptr(mask), ptr(flags), light_point.data_ptr(),
        ts.data_ptr(), ptr(t_map),
        ptr(centre_idx), ptr(centre_ts), ptr(out), ptr(idx), ptr(key),
        b, h, w, ts.numel(), veto, int(clamp), int(cfg.shadow_mask_cull), chunk, int(gate_on),
        cfg.shadow_resolution_scale, 0 if centre_ts is None else centre_ts.numel(),
        lo_x, hi_x, lo_y, hi_y, cfg.shadow_bias, t_lo, t_hi, count_as=count_as,
    )
    return out if key is None else key


def ray_march_min_distance_cuda(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    cfg: RenderConfig,
    ts=None,
    return_argmin_t: bool = False,
):
    """(B, H, W) depth and mask, (B, 3) light points -> (B, H, W) min distances.

    Same function as shadows.ray_march_min_distance_batch: kernel K1, or K2
    with `return_argmin_t`, which returns (min distances, t*). `ts` overrides
    the sample offsets (1-D float32, any length); t* then takes its values.
    When depth or the light point needs a gradient, the march over the full
    grid goes through `RayMarchMinDistance` (K2 forward, march_grad backward),
    and a march over given offsets through `RayMarchMinDistanceSP` with no
    group (K5 on one shard).
    """
    if needs_grad(depth, light_point):
        if return_argmin_t:
            raise NotImplementedError("the differentiable march returns distances only")
        if ts is not None:
            return RayMarchMinDistanceSP.apply(depth, mask, light_point, cfg, ts, None)
        return RayMarchMinDistance.apply(depth, mask, light_point, cfg)
    if depth.device.type == "cpu":
        return shadows.ray_march_min_distance_batch(depth, mask, light_point, cfg, ts, return_argmin_t)
    _check_inputs(depth, mask, light_point, cfg, "march")
    ts, clamp = _ts_for(depth.device, cfg, ts)
    if not return_argmin_t:
        return _launch("march", _stage(depth, mask, light_point, cfg), mask, light_point, ts, cfg, clamp=clamp)
    out, idx, _ = _launch_argmin(depth, mask, light_point, ts, cfg, clamp=clamp)
    # The index addresses the same float32 table the kernel read (shadows_pallas.py:1152-1154).
    return out, ts[idx.long()]


def _ts_for(dev: torch.device, cfg: RenderConfig, ts=None) -> tuple:
    """(the float32 t table on `dev`, whether the kernels take it with clamped taps at the
    config's size (_clamp)): the config's grid (its range known on the host), or the given
    offsets (read back once to tell)."""
    if ts is None:
        if dev.type == "cuda" and dev.index is None:  # one table for "cuda" and "cuda:<current>"
            dev = torch.device("cuda", torch.cuda.current_device())
        return _ts_on(dev, cfg.t_start, cfg.t_stop, cfg.t_step, cfg.num_sample_points), _grid_clamp(cfg)
    ts = torch.as_tensor(ts, dtype=torch.float32).reshape(-1)
    return ts.to(dev).contiguous(), _clamp(cfg.img_height, cfg.img_width, _in_unit(*_range(ts)))


def _grid_slice(dev: torch.device, cfg: RenderConfig, ts) -> tuple:
    """_ts_for for a rank's slice of the config's grid, where t* may be any rank's offset: the
    slice on `dev` and the grid's own clamp, which holds for every rank's offsets because each
    rank refuses a slice outside the grid's range (read back once)."""
    ts = torch.as_tensor(ts, dtype=torch.float32).reshape(-1)
    _, lo, hi = _grid_of(cfg)
    s_lo, s_hi = _range(ts)
    if not (lo <= s_lo and s_hi <= hi):
        raise ValueError(f"the slice's offsets [{s_lo}, {s_hi}] leave the grid's range [{lo}, {hi}]")
    return ts.to(dev).contiguous(), _grid_clamp(cfg)


def _launch_argmin(depth, mask, light_point, ts, cfg: RenderConfig, count_as=None, *, clamp: bool):
    """K2 after its staging (with the cull's flags): (min distances, int32 index of each pixel's
    first winning sample in ts, the shadows.Staged input it read). clamp: _ts_for's, with ts."""
    staged = _stage(depth, mask, light_point, cfg, flags=True)
    idx = torch.empty(depth.shape, dtype=torch.int32, device=depth.device)
    out = _launch("march_argmin", staged, None, light_point, ts, cfg, idx=idx, count_as=count_as, clamp=clamp)
    return out, idx, staged


def _argmin(depth, mask, light_point, ts, cfg: RenderConfig, count_as=None, *, clamp: bool):
    """(min distances, int32 first-winner index into ts, the staged input or None): K2 on CUDA
    tensors, its plain version on the CPU (which stages nothing)."""
    if depth.device.type == "cpu":
        return (*shadows.ray_march_argmin_batch(depth, mask, light_point, cfg, ts), None)
    _check_inputs(depth, mask, light_point, cfg, "march")
    return _launch_argmin(depth, mask, light_point, ts, cfg, count_as, clamp=clamp)


def _march_key(depth, mask, light_point, ts, cfg: RenderConfig, count_as=None, *, clamp: bool):
    """(int64 keys (B, H, W), the staged input or None): each pixel's (min distance, first winning
    t in ts) packed as shadows.pack_march_key packs them. On CUDA tensors K2's key form after its
    staging; on the CPU the plain argmin march and pack_march_key (no staging)."""
    if depth.device.type == "cpu":
        min_d, idx = shadows.ray_march_argmin_batch(depth, mask, light_point, cfg, ts)
        return shadows.pack_march_key(min_d, ts[idx.long()]), None
    _check_inputs(depth, mask, light_point, cfg, "march")
    if ts.numel() == 0:
        raise ValueError("the key form needs at least one sample offset")
    staged = _stage(depth, mask, light_point, cfg, flags=True)
    key = torch.empty(depth.shape, dtype=torch.int64, device=depth.device)
    return _launch("march_argmin", staged, None, light_point, ts, cfg, key=key, count_as=count_as,
                   clamp=clamp), staged


def unpack_march_key(key: torch.Tensor) -> tuple:
    """(distances, t*), float32, from int64 march keys: the unpack kernel (unpack_key_kernel) on a
    CUDA tensor, shadows.unpack_march_key on a CPU tensor; bit for bit the same."""
    if key.device.type == "cpu":
        return shadows.unpack_march_key(key)
    if key.dtype != torch.int64 or not key.is_contiguous():
        raise ValueError(f"the unpack reads contiguous int64 keys, got {key.dtype}")
    out = torch.empty(key.shape, dtype=torch.float32, device=key.device)
    t_star = torch.empty_like(out)
    LIBRARY.launch("unpack_key", key.device, key.data_ptr(), out.data_ptr(), t_star.data_ptr(), key.numel())
    return out, t_star


def _combine(key: torch.Tensor, group) -> tuple:
    """The group's march from each rank's keys: one MIN of the keys over the group (none
    without a group), then the unpack -> (min distances, t*), the same on every rank."""
    return unpack_march_key(all_min(key, group))


def _check_grad_inputs(depth, mask, light_point, grad, cfg: RenderConfig, staged):
    """march_grad's checks on the card (inputs, cotangent, the forward's staged quad and flags); grad contiguous."""
    _check_inputs(depth, mask, light_point, cfg, "march_grad")
    b, h, w = depth.shape
    dev = depth.device
    grad = grad.contiguous()
    check("grad", grad, (b, h, w), dev)
    if staged is None:
        raise ValueError("march_grad reads the forward's staged input: pass the shadows.Staged K2 read")
    check("the staged quad", staged.quad, (b, h + 1, w + 1, 2), dev)
    chunk = shadows.effective_col_chunk(cfg)
    units = (b, -(-h // 8), w // chunk)
    if cfg.shadow_mask_cull and (staged.flags is None or staged.flags.dtype != torch.uint8
                                 or tuple(staged.flags.shape) != units or staged.flags.device != dev):
        raise ValueError(f"the cull needs the staging's uint8 flags of shape {units}")
    return grad


def march_grad_cuda(depth, mask, light_point, idx, ts, grad, cfg: RenderConfig, staged=None):
    """(d_depth (B, H, W), d_light (B, 3)): K4's backward at K2's winners.

    Same function as shadows.march_vjp at t* = ts[idx]: idx is K2's int32
    winning index (B, H, W) into the float32 table ts it read, grad the
    (B, H, W) cotangent of the march's output. On CUDA tensors the kernel
    reads the forward's input, `staged` (the shadows.Staged that K2 read:
    its quad, and its cull flags where the config culls), not depth and
    mask; one zero fill makes both gradients (two views of one buffer). A
    table other than the config's own grid is read back once, to choose the
    kernel's taps (_ts_for).
    """
    if depth.device.type == "cpu":
        return shadows.march_vjp(depth, mask, light_point, ts[idx.long()], grad, cfg)
    grad = _check_grad_inputs(depth, mask, light_point, grad, cfg, staged)
    b, h, w = depth.shape
    if idx.dtype != torch.int32 or tuple(idx.shape) != (b, h, w) or not idx.is_contiguous() or idx.device != depth.device:
        raise ValueError("idx must be a contiguous int32 (B, H, W) tensor on the depth's device")
    check("ts", ts, (ts.numel(),), depth.device)
    grid, clamp = _ts_for(depth.device, cfg)
    if ts is not grid:
        clamp = _ts_for(depth.device, cfg, ts)[1]
    return _march_grad(light_point, idx, ts, grad, staged, cfg, clamp=clamp)


def march_grad_at_cuda(depth, mask, light_point, t_star, grad, cfg: RenderConfig, staged=None):
    """march_grad_cuda's t-map form: the VJP at each pixel's winning offset t_star (B, H, W)
    float32 itself, as K5's backward takes it from the unpack, with no table. Same function as
    shadows.march_vjp(depth, mask, light_point, t_star, grad, cfg); at t_star = ts[idx] the same
    floats as the index form."""
    if depth.device.type == "cpu":
        return shadows.march_vjp(depth, mask, light_point, t_star, grad, cfg)
    grad = _check_grad_inputs(depth, mask, light_point, grad, cfg, staged)
    check("t_star", t_star, tuple(depth.shape), depth.device)
    clamp = _ts_for(depth.device, cfg, t_star)[1]  # the kernel's taps; this waits for the card
    return _march_grad(light_point, None, None, grad, staged, cfg, t_map=t_star, clamp=clamp)


def _march_grad(light_point, idx, ts, grad, staged: shadows.Staged, cfg: RenderConfig, t_map=None, *,
                clamp: bool):
    """The march_grad launch on tensors already checked: the forward's own (the
    autograd backward's), or march_grad_cuda's; grad contiguous. At ts[idx], or
    at t_map where given; clamp: _ts_for's, for a table that holds those t."""
    b, h, w = grad.shape
    dev = grad.device
    grads = torch.zeros(b * h * w + 3 * b, dtype=torch.float32, device=dev)
    LIBRARY.launch(
        "march_grad", dev, staged.quad.data_ptr(), ptr(staged.flags if cfg.shadow_mask_cull else None),
        light_point.data_ptr(), ptr(ts), ptr(idx), ptr(t_map), grad.data_ptr(), grads.data_ptr(),
        grads.data_ptr() + 4 * b * h * w, b, h, w, int(clamp), shadows.effective_col_chunk(cfg),
    )
    return grads.as_strided((b, h, w), (h * w, w, 1)), grads.as_strided((b, 3), (3, 1), b * h * w)


def _save_forward(ctx, depth, mask, light_point, winner, staged, clamp: bool) -> None:
    """Keep what march_grad reads: the winners (K2's index, or K5's t map), the clamp of a table
    that holds their t, and on the card the staged quad and flags (not copies: K2's input)."""
    quad, flags = (staged.quad, staged.flags) if staged is not None else (None, None)
    ctx.clamp = clamp
    ctx.save_for_backward(depth, mask, light_point, winner, quad, flags)


def _backward(ctx, grad, ts=None):
    """march_grad at the forward's winners (its plain version on CPU tensors), from what
    _save_forward kept: at ts[idx], or without `ts` at the saved t map. The forward checked its
    inputs and made the winners and the staged quad."""
    depth, mask, light_point, winner, quad, flags = ctx.saved_tensors
    idx, t_map = (winner, None) if ts is not None else (None, winner)
    if quad is None:
        return shadows.march_vjp(depth, mask, light_point, t_map if ts is None else ts[idx.long()], grad, ctx.cfg)
    if grad.dtype != torch.float32 or grad.shape != winner.shape:
        raise ValueError(f"march_grad needs a float32 {tuple(winner.shape)} cotangent, got {grad.dtype} "
                         f"{tuple(grad.shape)}")
    return _march_grad(light_point, idx, ts, grad.contiguous(), shadows.Staged(quad, flags), ctx.cfg, t_map=t_map,
                       clamp=ctx.clamp)


class RayMarchMinDistance(torch.autograd.Function):
    """The differentiable full-grid march (B, H, W) -> (B, H, W), kernel K4.

    Forward: the argmin march, which records each pixel's winning sample
    (K2 on the card, after its staging). Backward: the VJP at that sample
    (march_grad on the card, reading the quad and flags K2 read), into depth
    and the light point; the mask gets none. On CPU
    tensors the same structure runs the plain argmin march and
    shadows.march_vjp. The draft tier has no gradient: its march is
    serving-only, as in the JAX package (render.py:189-193).
    """

    @staticmethod
    def forward(ctx, depth, mask, light_point, cfg: RenderConfig):
        if cfg.shadow_resolution_scale != 1:
            raise NotImplementedError("the draft tier's march has no gradient: it serves only")
        ctx.cfg = cfg
        ctx.ts, clamp = _ts_for(depth.device, cfg)
        out, idx, staged = _argmin(depth, mask, light_point, ctx.ts, cfg, clamp=clamp)
        _save_forward(ctx, depth, mask, light_point, idx, staged, clamp)
        return out

    @staticmethod
    def backward(ctx, grad):
        d_depth, d_light = _backward(ctx, grad, ctx.ts)
        return d_depth, None, d_light, None


def sharded_march(depth, mask, light_point, cfg: RenderConfig, ts_local, group, return_argmin_t: bool = False):
    """The march over the group's t grid, this rank marching `ts_local`; the same result on every rank.

    Serving form (infer.py:280-307 of the JAX package): K1 on the slice then
    the MIN over the group, or with `return_argmin_t` K2's key form on the
    slice, one MIN of the keys and the unpack -> (min distances, t*): the
    global minimum and the smallest t among the ranks that reach it, the full
    grid's first winner. The slices must be the group ranks' contiguous rows
    of `shadows.sharded_sample_ts`. A march that needs a gradient is K5.
    """
    if needs_grad(depth, light_point):
        if return_argmin_t:
            raise NotImplementedError("the differentiable march returns distances only")
        return RayMarchMinDistanceSP.apply(depth, mask, light_point, cfg, ts_local, group)
    if not return_argmin_t:
        return all_min(ray_march_min_distance_cuda(depth, mask, light_point, cfg, ts_local), group)
    ts_local, clamp = _ts_for(depth.device, cfg, ts_local)
    key, _ = _march_key(depth, mask, light_point, ts_local, cfg, clamp=clamp)
    return _combine(key, group)


class RayMarchMinDistanceSP(torch.autograd.Function):
    """The sample-sharded differentiable march, kernel K5 (shadows_pallas.py:814-871).

    apply(depth, mask, light_point, cfg, ts_local, group) -> (B, H, W), the
    same on every rank of `group` (None: one shard, ts_local is the grid).
    Forward: K2's key form on this rank's slice (counted as 'march_sp'), one
    MIN of the int64 keys over the group (the only collective), the unpack
    into the distances and each pixel's winning t*. Backward: march_grad at
    t* (its t-map form: no table), on the quad this rank's K2 read (every
    rank stages the same inputs), from the same residuals on every rank, so
    with no collective; its atomics may order the sums differently on two
    ranks, which is why the train step averages gradients over every rank.
    On CPU tensors: the plain argmin march on the slice,
    shadows.pack_march_key, the same MIN over gloo, shadows.unpack_march_key
    and shadows.march_vjp. With a group, each rank refuses a slice that
    leaves the config's grid's range (_grid_slice), so that the grid's taps
    hold for every rank's t*.
    """

    @staticmethod
    def forward(ctx, depth, mask, light_point, cfg: RenderConfig, ts_local, group):
        if cfg.shadow_resolution_scale != 1:
            raise NotImplementedError("the draft tier's march has no gradient: it serves only")
        ctx.cfg = cfg
        # One shard: t* is an offset of ts_local. With a group, of any rank's slice.
        table = _ts_for if group is None else _grid_slice
        ts_local, clamp = table(depth.device, cfg, ts_local)
        key, staged = _march_key(depth, mask, light_point, ts_local, cfg, count_as="march_sp", clamp=clamp)
        out, t_star = _combine(key, group)
        _save_forward(ctx, depth, mask, light_point, t_star, staged, clamp)
        return out

    @staticmethod
    def backward(ctx, grad):
        d_depth, d_light = _backward(ctx, grad)
        return d_depth, None, d_light, None, None, None


def refine_min_distance_cuda(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    t_map: torch.Tensor,
    cfg: RenderConfig,
    offsets=None,
) -> torch.Tensor:
    """(B, H, W) depth, mask and t_map, (B, 3) light points -> (B, H, W): kernel K3.

    Same function as shadows.refine_min_distance_batch. `offsets` overrides
    refine_offsets(cfg) (1-D float32, any length). The draft tier serves
    only: a call that needs a gradient raises.
    """
    if needs_grad(depth, light_point):
        raise NotImplementedError("the draft tier's refine has no gradient: it serves only")
    if depth.device.type == "cpu":
        return shadows.refine_min_distance_batch(depth, mask, light_point, t_map, cfg, offsets)
    _check_inputs(depth, mask, light_point, cfg, "refine")
    check("t_map", t_map, tuple(depth.shape), depth.device)
    return _launch("refine", _stage(depth, mask, light_point, cfg), mask, light_point,
                   _refine_offsets(depth.device, cfg, offsets), cfg, t_map=t_map)


def _refine_offsets(dev: torch.device, cfg: RenderConfig, offsets=None) -> torch.Tensor:
    """K3's window offsets on `dev`."""
    if offsets is None:
        return _offsets_on(dev, cfg.shadow_refine_halfwidth, cfg.t_step)
    return torch.as_tensor(offsets, dtype=torch.float32, device=dev).reshape(-1).contiguous()


def refine_around_argmin_cuda(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    idx: torch.Tensor,
    ts: torch.Tensor,
    cfg: RenderConfig,
    offsets=None,
) -> torch.Tensor:
    """K3 around K2's winners: (B, H, W) depth and mask, (B, 3) light points -> (B, H, W).

    idx is K2's int32 (B, H/s, W/s) winning index into the float32 table
    `ts` it read, s = cfg.shadow_resolution_scale. Same function as
    refine_min_distance_cuda(..., upsample_tstar_nn(ts[idx], cfg), cfg,
    offsets): the kernel reads each pixel's centre ts[idx[b, row/s, col/s]]
    itself, so no full-resolution t_map is made. Serves only, as the refine.
    """
    if needs_grad(depth, light_point):
        raise NotImplementedError("the draft tier's refine has no gradient: it serves only")
    if depth.device.type == "cpu":
        t_map = shadows.upsample_tstar_nn(ts[idx.long()], cfg)
        return shadows.refine_min_distance_batch(depth, mask, light_point, t_map, cfg, offsets)
    _check_inputs(depth, mask, light_point, cfg, "refine")
    b, h, w = depth.shape
    s, dev = cfg.shadow_resolution_scale, depth.device
    if h % s or w % s:
        raise ValueError(f"the draft scale {s} does not divide {h}x{w}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (b, h // s, w // s) or not idx.is_contiguous() \
            or idx.device != dev:
        raise ValueError(f"idx must be a contiguous int32 {(b, h // s, w // s)} tensor on the depth's device")
    check("ts", ts, (ts.numel(),), dev)
    return _launch("refine", _stage(depth, mask, light_point, cfg), mask, light_point,
                   _refine_offsets(dev, cfg, offsets), cfg, centre=(idx, ts))


def draft_march(depth: torch.Tensor, mask: torch.Tensor, light_point: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """The draft tier's march with its refine: (B, H, W) depth and mask, (B, 3) light points -> (B, H, W).

    Three launches: one staging pass (the pooled inputs of
    shadows.scale_march_inputs and the full-resolution ones, padded and
    interleaved, both resolutions' cull flags and the scaled light), K2 on
    the pooled inputs for each low-resolution pixel's winning index, then K3
    at full resolution around those winners. Same function as
    refine_min_distance_batch(depth, mask, light_point, upsample_tstar_nn(t*),
    cfg), t* the argmin march of the pooled inputs; on CPU tensors it runs
    those plain versions. Serves only, as the refine.
    """
    if cfg.shadow_resolution_scale == 1 or cfg.shadow_refine_halfwidth == 0:
        raise ValueError("draft_march needs shadow_resolution_scale > 1 and shadow_refine_halfwidth > 0")
    if needs_grad(depth, light_point):
        raise NotImplementedError("the draft tier's march has no gradient: it serves only")
    m_cfg = shadows.scaled_render_cfg(cfg)
    ts, clamp = _ts_for(depth.device, m_cfg)
    if depth.device.type == "cpu":
        m_depth, m_mask, m_light, _ = shadows.scale_march_inputs(depth, mask, light_point, cfg)
        _, idx = shadows.ray_march_argmin_batch(m_depth, m_mask, m_light, m_cfg, ts)
        return refine_around_argmin_cuda(depth, mask, light_point, idx, ts, cfg)
    _check_inputs(depth, mask, light_point, cfg, "draft march")
    b, h, w = depth.shape
    s = cfg.shadow_resolution_scale
    staged = _stage(depth, mask, light_point, cfg, draft=True, flags=True)
    idx = torch.empty((b, h // s, w // s), dtype=torch.int32, device=depth.device)
    _launch("march_argmin", staged, None, staged.light, ts, m_cfg, idx=idx, clamp=clamp)
    full = shadows.Staged(staged.full, staged.full_flags)
    return _launch("refine", full, None, light_point, _refine_offsets(depth.device, cfg), cfg, centre=(idx, ts))

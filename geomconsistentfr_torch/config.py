"""Behavioural constants of the PyTorch/CUDA port: a copy of the JAX package's config.

Field names, defaults, validation, presets and precision tiers match
`geomconsistentfr_tpu/config.py` one to one (tests/test_torch_config.py holds
the two together), so a config written for one package means the same thing
to the other. The port keeps its own copy rather than importing it.

Knobs that only tile the TPU kernel (`shadow_tile_rows`, `shadow_slab_rows`,
`shadow_unroll`, `shadow_slab_interleave`, `shadow_reduce`, `shadow_step_pack`)
are accepted and ignored here: they change no value the march computes
(the step pack only reorders the JAX kernel's float32 sums).
`shadow_matmul_precision` is read only to resolve `shadow_mask_gather='auto'`
('highest'/'high' -> one-hot veto, 'default' -> bilinear veto); the CUDA march
always gathers depth in full float32.

Reference provenance (paths relative to the reference repo):
  * image size / intensities / distances / sample counts:
      test_relight_single_image.py:15-22,
      test_relight_single_image_lighting_transfer.py:15-22
  * depth offset for normals: test_relight_single_image.py:326 (+1610) vs
      test_relight_single_image_lighting_transfer.py:325 (+1410)
  * focal length: test_relight_single_image.py:570 (1570) vs
      test_relight_single_image_lighting_transfer.py:530 (700)
  * ambient handling: test_relight_single_image.py:342 (est-0.1),
      test_raytracing_relighting_CelebAHQ_DSSIM_8x.py:341-342 (est),
      test_relight_single_image_lighting_transfer.py:348 (target arg),
      train_*.py:367 (est)
  * +5.0 shadow bias gate: test_relight_single_image.py:495-496 (light inside
      image) vs test_..._lighting_transfer.py:503-504 (4x bounds)
  * loss weights: train_raytracing_relighting_CelebAHQ_DSSIM_8x.py:621-645
  * skip-connection gate epochs: train_*.py (epoch > 8/10/12/14)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer constants (Lambertian shading + ray-marched shadows)."""

    img_height: int = 256
    img_width: int = 256

    # Lambertian term.
    directional_intensity: float = 0.5    # 0.41 for the lighting-transfer test
    light_distance: float = 4013.0

    # Ray-march sampling: t in [t_start, t_stop) with step t_step.
    num_sample_points: int = 160          # 159 for the lighting-transfer test
    t_start: float = 0.025                # 0.03 for the lighting-transfer test
    t_stop: float = 0.825
    t_step: float = 0.005

    # Depth head output is multiplied by this (train_*.py:349-350).
    depth_scale: float = 100.0
    # Offset added to depth before surface-normal estimation.
    depth_offset: float = 1610.0          # 1410 for the lighting-transfer test

    # Camera intrinsics (principal point is the image centre).
    focal_length: float = 1570.0          # 700 for the lighting-transfer test

    # Ambient source: 'estimated' | 'estimated_minus_0.1' | 'target'.
    ambient_mode: str = "estimated"

    # Light direction source: 'target' | 'self_estimated'.
    lighting_mode: str = "target"

    # Clamp applied to the *estimated* light z component before normalisation.
    z_clamp_min: float = 0.0

    # The "+5.0 to min distance" shadow gate: 'none' | 'inside_image' | 'wide'.
    shadow_bias_gate: str = "none"
    shadow_bias: float = 5.0

    # Samples per chunk of the plain march (bounds its temporary memory).
    march_chunk: int = 32

    # CUDA tensors always march through the hand-written kernel and CPU
    # tensors through the plain march; render() refuses False on CUDA tensors
    # rather than run the plain march there.
    use_pallas_shadows: bool = True

    # Gather precision of the JAX kernel. Here only the 'auto' veto reads it.
    shadow_matmul_precision: str = "highest"

    # TPU tiling knobs of the JAX kernel: accepted, ignored by the port.
    shadow_tile_rows: int = 8
    shadow_slab_rows: int = 0
    shadow_unroll: int = 1
    shadow_slab_interleave: bool = False
    shadow_step_pack: int = 1

    # Mask veto per march sample (the march's backward vetoes its winning
    # sample one-hot whatever this says, as the JAX package's custom VJP does):
    #   'onehot'   the face indicator at the banker's-rounded sample position
    #              (the reference's own veto);
    #   'bilinear' bilinear interpolation of the 0/1 indicator at the clipped
    #              -1e-4-shifted position, thresholded at > 0.5 (fast tier);
    #   'hat'      the banker's-rounded row, along it the two columns' hat
    #              weights at the clipped shifted x, thresholded at > 0.5;
    #   'hat_y'    the banker's-rounded column, the two rows' hat weights;
    #   'auto'     'onehot' for 'highest'/'high' precision, else 'bilinear'.
    shadow_mask_gather: str = "auto"

    # TPU reduction knob of the JAX kernel: accepted, ignored by the port.
    shadow_reduce: str = "auto"

    # Mask-aware march culling: pixels whose fixed 8-row group (or 8-row x
    # shadow_col_chunk block) holds no face store the all-vetoed sentinel
    # (1e6, plus the gate bias where gated) instead of marching. Exact on
    # every masked surface the reference shows; only raw min-distance values
    # at fully off-face blocks change. Off by default; the tiers enable it.
    shadow_mask_cull: bool = False

    # Column width of the cull block; 0 (or >= img_width) culls whole 8-row
    # groups.
    shadow_col_chunk: int = 0

    # Draft-tier march resolution divisor, boundary-refine halfwidth and
    # low-res t-grid stride: render marches s x s pooled inputs over every
    # r-th t (kernel K2), then re-marches 2 * halfwidth offsets around the
    # upsampled argmin at full resolution (kernel K3); see ops/shadows.py.
    shadow_resolution_scale: int = 1
    shadow_refine_halfwidth: int = 0
    shadow_lowres_t_stride: int = 1

    def __post_init__(self):
        # The one-hot veto matches round(s) + half_w against integer column
        # indices, which is only exact when half_w / half_h are integral.
        if self.img_height % 2 or self.img_width % 2:
            raise ValueError(
                "img_height and img_width must be even (the shadow veto "
                f"needs integral half-extents); got {self.img_height}x"
                f"{self.img_width}"
            )
        if self.shadow_resolution_scale not in (1, 2, 4):
            raise ValueError(
                "shadow_resolution_scale must be 1, 2 or 4; got "
                f"{self.shadow_resolution_scale}"
            )
        s = 2 * self.shadow_resolution_scale
        if self.shadow_resolution_scale > 1 and (
            self.img_height % s or self.img_width % s
        ):
            raise ValueError(
                "img dims must stay even after the draft-march downscale; "
                f"got {self.img_height}x{self.img_width} at scale "
                f"{self.shadow_resolution_scale}"
            )
        if self.shadow_lowres_t_stride > 1 and (
            self.shadow_resolution_scale == 1
            or self.shadow_refine_halfwidth < self.shadow_lowres_t_stride
        ):
            raise ValueError(
                "shadow_lowres_t_stride > 1 needs the draft-mode march "
                "(shadow_resolution_scale > 1) AND a refine window that "
                "covers the strided argmin error (shadow_refine_halfwidth "
                f">= stride); got stride {self.shadow_lowres_t_stride}, "
                f"scale {self.shadow_resolution_scale}, halfwidth "
                f"{self.shadow_refine_halfwidth}"
            )
        if self.shadow_col_chunk:
            if self.shadow_col_chunk % 8:
                raise ValueError(
                    "shadow_col_chunk must be a multiple of 8 (sublane "
                    f"granularity); got {self.shadow_col_chunk}"
                )
            eff = min(self.shadow_col_chunk, self.img_width)
            if self.img_width % eff:
                raise ValueError(
                    "shadow_col_chunk must divide img_width; got chunk "
                    f"{self.shadow_col_chunk} for width {self.img_width}"
                )
        if self.shadow_step_pack not in (1, 2):
            raise ValueError(
                f"shadow_step_pack must be 1 or 2; got {self.shadow_step_pack}"
            )
        if self.shadow_step_pack == 2 and self.shadow_mask_gather not in (
            "auto", "bilinear"
        ):
            raise ValueError(
                "shadow_step_pack=2 packs the bilinear-veto dataflow; use "
                f"shadow_mask_gather='bilinear' (got "
                f"{self.shadow_mask_gather!r})"
            )

    @property
    def half_w(self) -> float:
        return self.img_width / 2.0

    @property
    def half_h(self) -> float:
        return self.img_height / 2.0


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """RelightNet architecture configuration.

    The two reference variants differ only in the residual projection shortcuts:
      'target'    3x3 shortcuts with bias
      'transfer'  1x1 bias-free shortcuts
    """

    variant: str = "target"  # 'target' | 'transfer'

    in_channels: int = 3
    base_channels: int = 16
    encoder_channels: Tuple[int, ...] = (16, 32, 64, 155)
    identity_channels: int = 128   # first 128 channels of the bottleneck
    lighting_channels: int = 27    # remaining 27 channels feed the lighting head
    lighting_hidden: int = 128     # linear_SL1 width
    lighting_out: int = 4          # [ambient, lx, ly, lz]

    bn_momentum: float = 0.1       # torch BatchNorm2d default
    bn_eps: float = 1e-5
    leaky_slope: float = 0.2

    # Dot/conv precision of the JAX package. The port runs float32 convs
    # without TF32 whenever compute_dtype is 'float32', whatever this says.
    conv_precision: str = "default"

    # Activation dtype of the CNN: 'float32' or 'bfloat16'. Parameters, BN
    # moments and the lighting head stay float32; outputs are float32.
    compute_dtype: str = "float32"

    # Encoder skip connections open once the training epoch exceeds these.
    skip_gate_epochs: Tuple[int, int, int, int] = (8, 10, 12, 14)

    def skip_gates(self, epoch: int) -> Tuple[bool, bool, bool, bool]:
        return tuple(epoch > e for e in self.skip_gate_epochs)  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class PatchGANConfig:
    """70x70-style PatchGAN discriminator (train_*.py:15-35)."""

    channels: Tuple[int, ...] = (64, 128, 256, 512)
    kernel: int = 4
    leaky_slope: float = 0.2
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (train_raytracing_relighting_CelebAHQ_DSSIM_8x.py:621-645)."""

    reconstruction: float = 20.0
    depth: float = 1.0
    ambient: float = 2.5
    direction: float = 1.0
    albedo: float = 5.0
    gan: float = 0.01
    dssim: float = 8.0
    ambient_target: float = 0.5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 3
    learning_rate: float = 1e-4
    max_epochs: int = 1000
    batches_per_epoch: int = 700
    gd_ratio: int = 5
    dataset_size: int = 29890
    seed: int = 0
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    sync_batch_norm: bool = True
    checkpoint_every_steps: int = 700
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every_steps: int = 1
    data_residency: str = "auto"
    device_data_budget_mb: int = 2048


# ---------------------------------------------------------------------------
# Pipeline (model + renderer + training)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


# ---------------------------------------------------------------------------
# Presets: one per reference entry point
# ---------------------------------------------------------------------------


def preset_target_lighting_train() -> PipelineConfig:
    """train_raytracing_relighting_CelebAHQ_DSSIM_8x.py"""
    return PipelineConfig(
        model=ModelConfig(variant="target"),
        render=RenderConfig(
            ambient_mode="estimated",
            lighting_mode="self_estimated",
            z_clamp_min=0.0,
            shadow_bias_gate="none",
        ),
    )


def preset_transfer_train() -> PipelineConfig:
    """train_lighting_transfer.py (same renderer as target training)."""
    return PipelineConfig(
        model=ModelConfig(variant="transfer"),
        render=RenderConfig(
            ambient_mode="estimated",
            lighting_mode="self_estimated",
            z_clamp_min=0.0,
            shadow_bias_gate="none",
        ),
    )


def preset_single_image() -> PipelineConfig:
    """test_relight_single_image.py (target-lighting single-image inference)."""
    return PipelineConfig(
        model=ModelConfig(variant="target"),
        render=RenderConfig(
            ambient_mode="estimated_minus_0.1",
            lighting_mode="target",
            shadow_bias_gate="inside_image",
        ),
    )


def preset_multipie_eval() -> PipelineConfig:
    """test_raytracing_relighting_CelebAHQ_DSSIM_8x.py (862-image benchmark sweep)."""
    return PipelineConfig(
        model=ModelConfig(variant="target"),
        render=RenderConfig(
            ambient_mode="estimated",
            lighting_mode="target",
            shadow_bias_gate="inside_image",
        ),
    )


def preset_lighting_transfer() -> PipelineConfig:
    """test_relight_single_image_lighting_transfer.py (2-pass lighting transfer)."""
    return PipelineConfig(
        model=ModelConfig(variant="transfer"),
        render=RenderConfig(
            directional_intensity=0.41,
            num_sample_points=159,
            t_start=0.03,
            depth_offset=1410.0,
            focal_length=700.0,
            ambient_mode="target",
            lighting_mode="target",
            z_clamp_min=0.16,
            shadow_bias_gate="wide",
        ),
    )


PRESETS = {
    "target_lighting_train": preset_target_lighting_train,
    "transfer_train": preset_transfer_train,
    "single_image": preset_single_image,
    "multipie_eval": preset_multipie_eval,
    "lighting_transfer": preset_lighting_transfer,
}


# ---------------------------------------------------------------------------
# Precision tiers
# ---------------------------------------------------------------------------

# 'strict' and 'high': float32 CNN (no TF32) and the one-hot veto; on the card
#   both run the same exact kernel (an f32 gather there is exact, so the JAX
#   package's bf16x3 split for 'high' has no counterpart).
# 'fast':  bfloat16 CNN activations and the bilinear veto, float32 march.
# 'draft': 'fast' plus the quarter-resolution march over every other t
#   (kernel K2) and the full-resolution boundary refine (kernel K3), culled
#   in 8x64 blocks. shadow_step_pack=2 is the JAX kernel's TPU lane packing:
#   set for parity with the JAX config, ignored by the port.
PRECISION_TIERS = ("strict", "high", "fast", "draft")


def apply_precision_tier(cfg: "PipelineConfig", tier: str) -> "PipelineConfig":
    """Return cfg with the given serving-precision tier applied."""
    if tier not in PRECISION_TIERS:
        raise ValueError(f"unknown precision tier: {tier!r} (use one of {PRECISION_TIERS})")
    shadow = {
        "strict": "highest", "high": "high", "fast": "default",
        "draft": "default",
    }[tier]
    compute = "float32" if tier in ("strict", "high") else "bfloat16"
    scale = 4 if tier == "draft" else 1
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, compute_dtype=compute),
        render=dataclasses.replace(
            cfg.render,
            shadow_matmul_precision=shadow,
            shadow_resolution_scale=scale,
            shadow_refine_halfwidth=4 if tier == "draft" else 0,
            shadow_lowres_t_stride=2 if tier == "draft" else 1,
            shadow_step_pack=2 if tier == "draft" else 1,
            shadow_mask_cull=True,
            shadow_col_chunk=64 if tier == "draft" else 32,
        ),
    )


# ---------------------------------------------------------------------------
# Serialisation (the CLI's --config files; JAX config.py:615-651)
# ---------------------------------------------------------------------------


def to_dict(cfg: PipelineConfig) -> dict:
    return dataclasses.asdict(cfg)


def from_dict(data: dict, base: Optional[PipelineConfig] = None) -> PipelineConfig:
    """Build a PipelineConfig from (possibly partial) nested dicts on top of `base`.

    Unknown keys raise; lists become tuples for tuple-typed fields.
    """

    def merge(dc, overrides: dict):
        fields = {f.name for f in dataclasses.fields(dc)}
        kwargs = {}
        for key, value in overrides.items():
            if key not in fields:
                raise KeyError(f"unknown config field: {type(dc).__name__}.{key}")
            current = getattr(dc, key)
            if dataclasses.is_dataclass(current) and isinstance(value, dict):
                kwargs[key] = merge(current, value)
            elif isinstance(current, tuple) and isinstance(value, (list, tuple)):
                kwargs[key] = tuple(value)
            else:
                kwargs[key] = value
        return dataclasses.replace(dc, **kwargs)

    return merge(base or PipelineConfig(), data)


def load_config(path: str, preset: Optional[str] = None) -> PipelineConfig:
    """A JSON config file: full or partial overrides on top of a preset."""
    with open(path) as f:
        data = json.load(f)
    return from_dict(data, PRESETS[preset]() if preset else PipelineConfig())

"""Named target-lighting presets (a copy of geomconsistentfr_tpu/lighting_presets.py).

The reference hard-codes these direction vectors as commented-out blocks in
test_relight_single_image.py:519-562 (Multi-PIE flash directions plus
azimuth/elevation presets). Ambient defaults to 0.5 (:517). The port keeps
its own copy; tests/test_torch_io.py holds it equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

# name -> (lx, ly, lz) unit-ish direction, +x right, +y up, +z toward camera.
#
# The 8 script-named Multi-PIE flashes carry the exact values from the
# reference comments (test_relight_single_image.py:519-562). The other 10
# are recovered from the reference's bundled sphere renderings
# (lighting_visualizations/Multi-PIE_lighting_{01..18}.png) by
# tools/fit_lighting_presets.recover_flash_directions. 01-13 form the rig's
# horizontal arc, 14-18 the elevated arc; 07 is the frontal flash.
LIGHT_PRESETS: dict[str, tuple[float, float, float]] = {
    "multipie_01": (0.9970, 0.0587, 0.0499),   # recovered
    "multipie_02": (0.9522, 0.0315, 0.3037),   # recovered
    "multipie_03": (0.8671, 0.0074, 0.4981),   # recovered
    "multipie_04": (0.7518, 0.0, 0.6594),
    "multipie_05": (0.5145, 0.0, 0.8575),
    "multipie_06": (0.2865, 0.0007, 0.9581),   # recovered
    "multipie_07": (0.0680, -0.0956, 0.9931),  # recovered
    "multipie_08": (-0.3315, 0.0013, 0.9435),  # recovered
    "multipie_09": (-0.5843, 0.0, 0.8115),
    "multipie_10": (-0.7574, 0.0, 0.6529),
    "multipie_11": (-0.8379, 0.0108, 0.5457),  # recovered
    "multipie_12": (-0.9405, 0.0387, 0.3375),  # recovered
    "multipie_13": (-0.9962, 0.0705, 0.0502),  # recovered
    "multipie_14": (0.6893, 0.3991, 0.6047),
    "multipie_15": (0.4478, 0.4925, 0.7463),
    "multipie_16": (-0.0014, 0.5593, 0.8290),  # recovered
    "multipie_17": (-0.5151, 0.4722, 0.7154),
    "multipie_18": (-0.7076, 0.3892, 0.5897),
    "A00E45": (0.0, 0.7071, 0.7071),      # top
    "A60E-20": (-0.8138, -0.3420, 0.4698),  # bottom left
    "A-60E-20": (0.8138, -0.3420, 0.4698),  # bottom right
}

# The 18-flash Multi-PIE evaluation order (test_raytracing_...py:513 reads
# the directions from MP_data/MP_lighting_directions.mat).
MULTIPIE_FLASH_ORDER: tuple[str, ...] = tuple(f"multipie_{i:02d}" for i in range(1, 19))

DEFAULT_AMBIENT = 0.5

# The presets the reference's golden FFHQ outputs were made with (comments at
# test_relight_single_image.py:519-562).
GOLDEN_FFHQ_PRESETS: dict[str, str] = {
    "00104": "multipie_14",
    "00110": "multipie_04",
    "00290": "multipie_09",
    "00295": "A00E45",
    "00300": "multipie_04",
    "00322": "multipie_10",
    "00508": "A-60E-20",
    "00525": "multipie_04",
    "00572": "multipie_10",
    "00695": "multipie_17",
}


def lighting_sphere(
    direction,
    size: int = 256,
    ambient: float = 0.458,
    directional: float = 0.572,
    clamp: bool = False,
    light_distance: float = 4013.0,
) -> np.ndarray:
    """Render a Lambertian sphere lit from ``direction`` (an (lx, ly, lz)).

    Counterpart of the reference's bundled ``lighting_visualizations/*.png``.
    The defaults fit those assets: ``ambient + directional * (n . l)`` without
    the clamp. ``clamp=True, ambient=0.5, directional=0.5`` gives the face
    renderer's shading model (a point light at ``light_distance * direction``).

    Returns (size, size) float32 in [0, 1]; the background is 0.
    """
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    radius = size / 2.0 - 1.0
    c = (size - 1) / 2.0
    ys, xs = np.mgrid[0:size, 0:size]
    nx = (xs - c) / radius
    ny = -(ys - c) / radius  # +y is up; image rows grow downward
    rr2 = nx * nx + ny * ny
    nz = np.sqrt(np.maximum(1.0 - rr2, 0.0))
    # Point light at light_distance * d; the incident direction from each
    # surface point (the radius-scaled normal) toward it.
    p = np.stack([nx, ny, nz], -1) * radius
    incident = light_distance * d - p
    incident /= np.maximum(np.linalg.norm(incident, axis=-1, keepdims=True), 1e-12)
    ndotl = nx * incident[..., 0] + ny * incident[..., 1] + nz * incident[..., 2]
    if clamp:
        ndotl = np.maximum(ndotl, 0.0)
    shading = ambient + directional * ndotl
    coverage = np.clip(radius + 0.5 - np.sqrt(rr2) * radius, 0.0, 1.0)
    return (np.clip(shading, 0.0, 1.0) * coverage).astype(np.float32)


def azimuth_elevation(azimuth_deg: float, elevation_deg: float) -> tuple[float, float, float]:
    """Unit light direction from azimuth (around +y, 0 = frontal) and elevation."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    return (
        float(-np.sin(az) * np.cos(el)),
        float(np.sin(el)),
        float(np.cos(az) * np.cos(el)),
    )

"""The yardstick's work counts: operations and bytes that the inputs need.

Nothing here reads the program. The CNN's operations come from the
architecture table below at the cell's shapes (2 per multiply-add of each
convolution, transposed convolution and linear layer, as torch's
FlopCounterMode counts them; tests/test_work.py holds the two equal). The
march's come from the face pixels, the samples and the veto alone.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 67
TFLOP/s in float32 outside the tensor cores (the program's float32 CNN runs
with TF32 off) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Float32 operations per pixel-sample of the march (an FMA counts 2; min,
# max, floor, ceil, rint and compares 1): coordinates 8, one-hot veto 8,
# depth taps 12, tap weights 4, bilinear depth 9, BA 5, cross product 9,
# norm^2 5, the running min 2 = 62. The bilinear veto's sample is 83. The
# argmin march (training's forward) carries the winning index too: +2.
OPS_PER_SAMPLE = {"onehot": 62, "bilinear": 83}
ARGMIN_EXTRA_OPS = 2
# Per pixel: the endpoint, BC, the denominator and the final sqrt and division.
OPS_PER_PIXEL = 40
# The march's backward per face pixel: the setup 40, the sample at t* 63 and
# the chain rule 95 into depth, position, endpoint and light, and the light's
# reduction 15.
GRAD_OPS_PER_PIXEL = 213

ENCODER = ((16, 32, 2), (32, 64, 3), (64, 155, 4))  # (cin, cout, level): H / 2**level
DECODER = ((128, 64, 4, True), (64, 32, 3, True), (32, 16, 2, True), (16, 16, 1, False))
SKIP_WIDTH = (64, 32, 16, 16)


def relightnet_layers(variant: str, h: int, w: int):
    """[(cin, cout, k, out_h, out_w)] of every convolution, then [(in, out)] of the linears."""
    sc = 3 if variant == "target" else 1
    convs = [(3, 16, 5, h, w), (16, 16, 3, h // 2, w // 2), (16, 16, 3, h // 2, w // 2)]
    for cin, cout, lv in ENCODER:
        r = (h >> lv, w >> lv)
        convs += [(cin, cout, 3, *r), (cout, cout, 3, *r), (cin, cout, sc, *r)]
    for _ in ("albedo", "depth"):
        for i, (cin, feat, lv, shortcut) in enumerate(DECODER):
            r = (h >> lv, w >> lv)
            convs += [(cin, feat, 3, *r), (feat, feat, 3, *r)]
            if shortcut:
                convs.append((cin, feat, sc, *r))
            c, up = SKIP_WIDTH[i], (h >> (lv - 1), w >> (lv - 1))
            convs += [(c, c, 3, *up), (c, c, 3, *up)]
        convs += [(16, 16, 3, h, w), (16, 16, 1, h, w), (16, 16, 1, h, w)]
    convs += [(16, 3, 1, h, w), (16, 1, 1, h, w)]
    return convs, [(27, 128), (128, 4)]


def conv_flops(cin, cout, k, oh, ow) -> int:
    return 2 * cin * cout * k * k * oh * ow


def relightnet_flops(variant: str, h: int, w: int) -> int:
    """Forward operations of one image."""
    convs, linears = relightnet_layers(variant, h, w)
    return sum(conv_flops(*c) for c in convs) + sum(2 * i * o for i, o in linears)


def relightnet_encoder_flops(variant: str, h: int, w: int) -> int:
    """Forward operations of one image through the encoder and the lighting head alone (the
    first 12 convolutions and both linears): all that an estimate of the light needs."""
    convs, linears = relightnet_layers(variant, h, w)
    return sum(conv_flops(*c) for c in convs[:3 + 3 * len(ENCODER)]) + sum(2 * i * o for i, o in linears)


def relightnet_first_conv_flops(h: int, w: int) -> int:
    return conv_flops(3, 16, 5, h, w)


def patchgan_layers(h: int, w: int, channels=(64, 128, 256, 512)):
    """[(cin, cout, k, out_h, out_w)] of the discriminator's five convolutions."""
    layers, cin = [], 3
    for c in channels:
        h, w = h // 2, w // 2
        layers.append((cin, c, 4, h, w))
        cin = c
    layers.append((cin, 1, 4, h - 1, w - 1))
    return layers


def train_step_flops(variant: str, batch: int, h: int, w: int) -> dict:
    """The CNN work of one GAN step, term by term (operations, whole batch).

    generator: forward F, backward 2F less the first convolution's input
      gradient (the photos need none);
    discriminator: three forwards (fake detached, real, fake for G); the
      backward of the discriminator's loss through the first two, weight
      gradients of all five convolutions and input gradients of conv2-5; the
      backward of the adversarial term through the third, input gradients of
      all five and no weight gradient (its parameters are constants there).
    The renderer's Sobel filter and SSIM's blur, under 1% together, are left out.
    """
    g_f = relightnet_flops(variant, h, w)
    d = [conv_flops(*layer) for layer in patchgan_layers(h, w)]
    d_f = sum(d)
    terms = {
        "generator_forward": g_f,
        "generator_backward": 2 * g_f - relightnet_first_conv_flops(h, w),
        "discriminator_forwards": 3 * d_f,
        "discriminator_backward": 2 * (d_f + sum(d[1:])) + d_f,
    }
    return {k: v * batch for k, v in terms.items()}


def march_ops(face_pixels: int, samples: int, veto: str, argmin: bool = False) -> int:
    per_sample = OPS_PER_SAMPLE[veto] + (ARGMIN_EXTRA_OPS if argmin else 0)
    return face_pixels * (samples * per_sample + OPS_PER_PIXEL)


def march_grad_ops(face_pixels: int) -> int:
    return face_pixels * GRAD_OPS_PER_PIXEL


def march_bytes(images: int, h: int, w: int, samples: int) -> int:
    """Depth and mask read once, the distances written once, the lights and the t table (float32)."""
    return 4 * (3 * images * h * w + 3 * images + samples)


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def veto(rcfg: dict) -> str:
    """The march's mask veto under a config's render group ('auto' resolved as the config defines it)."""
    mode = rcfg["shadow_mask_gather"]
    if mode == "auto":
        return "bilinear" if rcfg["shadow_matmul_precision"] == "default" else "onehot"
    return mode

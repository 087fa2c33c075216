"""The yardstick's work count of S3FD: operations that a frame needs, from the architecture
alone (gcfr_bench/work.py's conventions: 2 per multiply-add of each convolution, the peaks
there).

`s3fd_layers(h, w)` lists every convolution of S3FD on an (h, w) input, the frame as the
detector sees it (padded by 50 px a side): VGG16's conv1_1 - conv5_3, fc6 (3x3, padding 3,
so its map grows by 4), fc7, the extras conv6_1 - conv7_2 (the 3x3 ones at stride 2), and
the twelve head convolutions (3x3, padding 1; the first head's scores have 4 channels).
L2Norm, the pooling, the ReLUs, the softmax and the decode are left out: under 0.1% of a
frame's operations. The count is of direct convolution: a Winograd or FFT algorithm, which
cuDNN may pick, does fewer multiplications for the same answer.
"""

from __future__ import annotations

VGG = ((3, 64), (64, 64), "pool", (64, 128), (128, 128), "pool", (128, 256), (256, 256), (256, 256), "pool",
       (256, 512), (512, 512), (512, 512), "pool", (512, 512), (512, 512), (512, 512), "pool")
# The heads' sources among the layers below (their input channels) and the first head's score width.
HEAD_SOURCES = ("conv3_3", "conv4_3", "conv5_3", "fc7", "conv6_2", "conv7_2")


def _strided(n: int) -> int:
    """A 3x3, stride 2, padding 1 convolution's output size."""
    return (n - 1) // 2 + 1


def s3fd_layers(h: int, w: int):
    """[(name, cin, cout, k, out_h, out_w)] of every convolution of S3FD on an (h, w) input."""
    layers, names = [], iter(["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
                              "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3"])
    for layer in VGG:
        if layer == "pool":
            h, w = h // 2, w // 2
        else:
            layers.append((next(names), *layer, 3, h, w))
    h, w = h + 4, w + 4
    layers += [("fc6", 512, 1024, 3, h, w), ("fc7", 1024, 1024, 1, h, w), ("conv6_1", 1024, 256, 1, h, w)]
    h, w = _strided(h), _strided(w)
    layers += [("conv6_2", 256, 512, 3, h, w), ("conv7_1", 512, 128, 1, h, w)]
    h, w = _strided(h), _strided(w)
    layers.append(("conv7_2", 128, 256, 3, h, w))
    by_name = {name: (cout, oh, ow) for name, _, cout, _, oh, ow in layers}
    for i, src in enumerate(HEAD_SOURCES):
        c, oh, ow = by_name[src]
        layers += [(f"{src}_mbox_conf", c, 4 if i == 0 else 2, 3, oh, ow), (f"{src}_mbox_loc", c, 4, 3, oh, ow)]
    return layers


def s3fd_flops(h: int, w: int) -> int:
    """Forward operations of one (h, w) input."""
    return sum(2 * cin * cout * k * k * oh * ow for _, cin, cout, k, oh, ow in s3fd_layers(h, w))

"""The 862-image Multi-PIE-relit CelebA-HQ evaluation, end to end.

Port of geomconsistentfr_tpu/metrics/eval_multipie.py. It replaces the
reference's pipeline (the inference dump of
test_raytracing_relighting_CelebAHQ_DSSIM_8x.py:603-608, then MATLAB's
DSSIM_MP_RGB.m and MSE_MP.m and PerceptualSimilarity/test_network.py over
the dumped PNGs):

  1. `run_inference` relights each input with its target Multi-PIE lighting
     (the index parsed from the GT filename, test_raytracing_...py:525-527)
     and writes six files per image in the reference's layout;
  2. `evaluate_output_dir` scores rendered against GT with masked MSE, masked
     MATLAB-parity DSSIM and PSNR, and, given an LPIPS map function
     (models/lpips.LPIPSMetric), the masked spatial LPIPS.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

from geomconsistentfr_torch.data.multipie import lighting_index, load_lighting_directions
from geomconsistentfr_torch.infer import AsyncFetch
from geomconsistentfr_torch.metrics.image_metrics import masked_dssim_matlab, masked_mse, psnr
from geomconsistentfr_torch.parallel.distributed import is_writer
from geomconsistentfr_torch.utils.io import imread, read_image_u8, read_mask_u8, save_visual_pack


def _stem_id(name: str) -> Optional[str]:
    """The first digit run of a filename stem: the image id in the MP layout."""
    m = re.search(r"\d+", os.path.splitext(name)[0])
    return str(int(m.group(0))) if m else None  # insensitive to zero padding


def _check_pairing(triples, what: str) -> None:
    """Each triple's files must agree on their image id (where they carry one)."""
    for triple in triples:
        ids = {name: _stem_id(name) for name in triple}
        if len({v for v in ids.values() if v is not None}) > 1:
            raise ValueError(f"mispaired {what} triple (image ids differ): {ids}")


def evaluate_output_dir(output_dir: str, gt_dir: str, mask_dir: str, lpips_fn=None) -> Dict[str, float]:
    """Score a six-files-per-image inference dump against ground truth.

    The reference pairs `sorted()` listings by position (the rendered image is
    the 3rd of each 6-file group: DSSIM_MP_RGB.m:3-4), so one stray file
    mispairs everything after it. Here rendered images are picked by their
    `_rendered_image` suffix, and each rendered / GT / mask triple must agree
    on its image id; every pairing is checked before any pixel is read.

    `lpips_fn(gt01, pred01)` -> an (H, W) map adds masked_lpips_mean and _std:
    per image sum(mask * map) over the count of its nonzero products
    (test_network.py:46-48).
    """
    rendered = [f for f in sorted(os.listdir(output_dir)) if os.path.splitext(f)[0].endswith("_rendered_image")]
    gts = sorted(os.listdir(gt_dir))
    masks = sorted(os.listdir(mask_dir))
    if not (len(rendered) == len(gts) == len(masks)):
        raise ValueError(f"count mismatch: {len(rendered)} rendered vs {len(gts)} GT vs {len(masks)} masks")
    _check_pairing(zip(rendered, gts, masks), "eval")

    mses, dssims, psnrs, lpipss = [], [], [], []
    for pred_name, gt_name, mask_name in zip(rendered, gts, masks):
        pred = np.asarray(imread(os.path.join(output_dir, pred_name)), np.float64) / 255.0
        gt = np.asarray(imread(os.path.join(gt_dir, gt_name)), np.float64) / 255.0
        mask = np.asarray(imread(os.path.join(mask_dir, mask_name)), np.float64)
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = mask / 255.0
        if not np.any(mask > 0):
            raise ValueError(f"empty face mask: {mask_name!r}; masked metrics undefined")
        mses.append(masked_mse(pred, gt, mask))
        dssims.append(masked_dssim_matlab(pred, gt, mask))
        psnrs.append(psnr(pred * mask[..., None], gt * mask[..., None]))
        if lpips_fn is not None:
            weighted = mask * lpips_fn(gt, pred)
            lpipss.append(float(np.sum(weighted)) / max(float(np.sum(weighted > 0)), 1.0))
    result = {
        "masked_mse_mean": float(np.mean(mses)),
        "masked_dssim_mean": float(np.mean(dssims)),
        "masked_psnr_mean": float(np.mean(psnrs)),
        "num_images": float(len(mses)),
    }
    if lpipss:
        result["masked_lpips_mean"] = float(np.mean(lpipss))
        result["masked_lpips_std"] = float(np.std(lpipss))
    return result


def run_inference(
    relighter,
    input_dir: str,
    gt_dir: str,
    lighting_mat: str,
    mask_fill_nose_dir: str,
    output_dir: str,
    limit: Optional[int] = None,
    batch_size: int = 8,
) -> int:
    """Relight the MP evaluation set and dump six PNGs per image (the reference's layout).

    The target light is the MP_lighting_directions.mat row the GT filename
    names (test_raytracing_...py:525-527); the ambient is the model's own
    estimate under the multipie_eval preset. Each input / GT / mask triple
    must agree on its image id, and the lighting index is parsed from the
    verified GT partner, so a mispairing raises before any work is done.

    Batches of `batch_size` go to the device as uint8, the tail padded with
    its last image. One batch stays in flight: its packed visuals copy to
    pinned host memory while the host reads the next batch's files, and
    its PNGs are written after the next batch is dispatched.

    Over a mesh of several ranks (torchrun), every rank reads the same
    files and runs the same batches (sharded over the mesh when the
    relighter's parallel mode is 'data': batch_size a multiple of the
    world); only rank 0 writes the PNGs.
    """
    inputs = sorted(os.listdir(input_dir))
    gts = sorted(os.listdir(gt_dir))
    masks = sorted(os.listdir(mask_fill_nose_dir))
    if not (len(inputs) == len(gts) == len(masks)):
        raise ValueError(f"count mismatch: {len(inputs)} inputs vs {len(gts)} GT vs {len(masks)} masks")
    _check_pairing(zip(inputs, gts, masks), "inference")
    directions = load_lighting_directions(lighting_mat)
    size = relighter.cfg.render.img_height
    n = len(inputs) if limit is None else min(limit, len(inputs))
    os.makedirs(output_dir, exist_ok=True)

    writer = is_writer()

    def flush(fetch, start, stop):
        pack, _ = fetch.wait()
        if not writer:
            return
        for k, i in enumerate(range(start, stop)):
            save_visual_pack(output_dir, inputs[i].split(".")[0], pack[k])

    pending = None
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        imgs = [read_image_u8(os.path.join(input_dir, inputs[i]), size=size) for i in range(start, stop)]
        msks = [read_mask_u8(os.path.join(mask_fill_nose_dir, masks[i]), size=size) for i in range(start, stop)]
        lights = [directions[lighting_index(gts[i])] for i in range(start, stop)]
        pad = batch_size - (stop - start)
        imgs += [imgs[-1]] * pad
        msks += [msks[-1]] * pad
        lights += [lights[-1]] * pad
        fetch = AsyncFetch(relighter.device)
        fetch.copy(relighter.forward_visuals(np.stack(imgs), np.stack(msks),
                                             target_light=np.asarray(lights, np.float32)))
        if pending is not None:
            flush(*pending)
        pending = (fetch, start, stop)
    if pending is not None:
        flush(*pending)
    return n

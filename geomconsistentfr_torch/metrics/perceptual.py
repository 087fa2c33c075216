"""Perceptual-metric extras of the vendored LPIPS library's surface (numpy, on the host).

A copy of geomconsistentfr_tpu/metrics/perceptual.py (the port imports
nothing of the JAX package). The reference vendors PerceptualSimilarity,
whose metric classes beyond LPIPS are `L2` and `DSSIM`
(lpips/__init__.py:13-125), with a 2AFC / JND scoring harness
(lpips/trainer.py):

  * l2_distance         mean squared distance
  * dssim_distance      (1 - SSIM) / 2 on [0, 1] images (MATLAB-parity SSIM)
  * score_2afc          the mean agreement with the human judgements
  * score_jnd           average precision of "same" by ascending distance
  * write_html_gallery  a table of images (lpips util/html.py)
"""

from __future__ import annotations

import html
import os
from typing import Callable, Sequence

import numpy as np

from geomconsistentfr_torch.metrics.image_metrics import matlab_ssim_map

DistanceFn = Callable[[np.ndarray, np.ndarray], float]


def l2_distance(x: np.ndarray, y: np.ndarray) -> float:
    """Mean squared distance (lpips.L2 with colorspace='RGB')."""
    return float(np.mean((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2))


def dssim_distance(x: np.ndarray, y: np.ndarray) -> float:
    """(1 - SSIM) / 2 (lpips.DSSIM)."""
    return float((1.0 - matlab_ssim_map(x, y).mean()) / 2.0)


def score_2afc(refs: Sequence[np.ndarray], p0s: Sequence[np.ndarray], p1s: Sequence[np.ndarray],
               judges: Sequence[float], distance: DistanceFn) -> float:
    """Two-alternative forced choice score (lpips/trainer.py score_2afc_dataset).

    `judge` in [0, 1] is the fraction of humans who preferred p1. A triplet
    scores 1 - judge when the metric prefers p0 (d0 < d1), judge when it
    prefers p1, 0.5 on a tie; the score is the mean.
    """
    scores = []
    for ref, p0, p1, judge in zip(refs, p0s, p1s, judges):
        d0, d1 = distance(ref, p0), distance(ref, p1)
        scores.append((d0 < d1) * (1.0 - judge) + (d1 < d0) * judge + (d0 == d1) * 0.5)
    return float(np.mean(scores))


def score_jnd(p0s: Sequence[np.ndarray], p1s: Sequence[np.ndarray], same: Sequence[float],
              distance: DistanceFn) -> float:
    """JND score (lpips/trainer.py score_jnd_dataset): the average precision of
    `same` sorted by ascending distance, VOC-style over the recall curve."""
    ds = np.asarray([distance(a, b) for a, b in zip(p0s, p1s)])
    sames = np.asarray(same, np.float64)
    sorted_same = sames[np.argsort(ds)]
    tps = np.cumsum(sorted_same)
    fps = np.cumsum(1.0 - sorted_same)
    fns = sames.sum() - tps
    precision = tps / np.maximum(tps + fps, 1e-12)
    recall = tps / np.maximum(tps + fns, 1e-12)
    ap, prev_r = 0.0, 0.0
    for p, r in zip(precision, recall):
        ap += p * max(0.0, r - prev_r)
        prev_r = r
    return float(ap)


def write_html_gallery(out_path: str, rows: Sequence[dict], title: str = "results") -> None:
    """A minimal results page (lpips util/html.py): each row {label: image path or value}
    becomes a table row, the images linked relative to the page."""
    cols = sorted({k for row in rows for k in row})
    parts = [f"<html><head><title>{html.escape(title)}</title></head><body>"]
    parts.append(f"<h2>{html.escape(title)}</h2><table border=1>")
    parts.append("<tr>" + "".join(f"<th>{html.escape(c)}</th>" for c in cols) + "</tr>")
    for row in rows:
        cells = []
        for c in cols:
            v = row.get(c, "")
            if isinstance(v, str) and v.lower().endswith((".png", ".jpg", ".jpeg")):
                rel = os.path.relpath(v, os.path.dirname(os.path.abspath(out_path)))
                cells.append(f'<td><img src="{html.escape(rel)}" width=192></td>')
            else:
                cells.append(f"<td>{html.escape(str(v))}</td>")
        parts.append("<tr>" + "".join(cells) + "</tr>")
    parts.append("</table></body></html>")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(parts))

"""The offline batch job: `Relighter.forward_visuals` on batches of faces, one caller
in a closed loop.

Traffic: `batch` images a call, `pool_batches` distinct batches made at set-up
and sent in turn. Each batch's faces are drawn by seed from the ten of the
data file, each image moved by a seeded jitter of at most `jitter_levels`,
each with its own mask and a seeded light (z >= `light_z_min`). Each call
uploads the batch's uint8 images and masks from pinned host memory and
fetches the packed uint8 visuals (B, H, W, 12) back into it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from gcfr_bench import core
from gcfr_bench.drivers._relight import RelightDriver
from gcfr_bench.reference import render as ref_render


class Driver(RelightDriver):
    rate_metric = "relight_img_per_s"

    def _make_inputs(self) -> None:
        b, p = int(self.traffic["batch"]), int(self.traffic["pool_batches"])
        ids = torch.randint(0, 10, (p * b,), generator=self.gen, device=self.device)
        images, masks = core.jittered_faces(self.gen, ids, self.device, int(self.traffic["jitter_levels"]), self.size)
        lights = core.seeded_lights(self.gen, p * b, self.device, float(self.traffic["light_z_min"]))
        face_px = (masks != 0).view(p, -1).sum(dim=1).tolist()
        self.inputs = [(self._pinned(images[k * b:(k + 1) * b]), self._pinned(masks[k * b:(k + 1) * b]),
                        lights[k * b:(k + 1) * b].cpu()) for k in range(p)]
        self.face_px = [int(f) for f in face_px]
        self.batch, self.n_inputs = b, p

    def _call(self, k: int, spans: bool) -> torch.Tensor:
        images, masks, lights = self.inputs[k]
        if not spans:
            return self.rl.forward_visuals(images, masks, target_light=lights)
        with record_function("entry.forward_visuals"):
            return self.rl.forward_visuals(images, masks, target_light=lights)

    def _work(self, k: int):
        return self.batch, self.batch, self.face_px[k]

    def _cnn_input(self) -> torch.Tensor:
        return self.inputs[0][0].to(self.device).float() / 255.0

    def _reference(self, k: int):
        images, masks, lights = self.inputs[k]
        out, face = [], []
        for s in range(0, self.batch, 16):
            albedo, depth, _, mask, r = self._ref_forward(images[s:s + 16], masks[s:s + 16], lights[s:s + 16])
            out.append(ref_render.visual_pack(albedo, depth, r, mask).cpu().numpy())
            face.append((masks[s:s + 16] != 0).numpy())
        return np.concatenate(out), np.concatenate(face)

"""The light-sweep gallery (`cli sweep`): `Relighter.relight_sweep_rendered_u8`, one
face under many lights a call, one caller in a closed loop.

Traffic: `lights` seeded lights (z >= `light_z_min`) a call, `pool_calls`
distinct (face, lights) calls made at set-up and sent in turn; each face is
drawn by seed from the ten of the data file, moved by a seeded jitter of at
most `jitter_levels`. The CNN runs once at batch 1, the renderer and the
march at batch `lights`; the uint8 renders (L, H, W, 3) are fetched into
pinned host memory.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from gcfr_bench import core
from gcfr_bench.drivers._relight import RelightDriver
from gcfr_bench.reference import render as ref_render


class Driver(RelightDriver):
    rate_metric = "sweep_img_per_s"

    def _make_inputs(self) -> None:
        n, p = int(self.traffic["lights"]), int(self.traffic["pool_calls"])
        ids = torch.randint(0, 10, (p,), generator=self.gen, device=self.device)
        images, masks = core.jittered_faces(self.gen, ids, self.device, int(self.traffic["jitter_levels"]), self.size)
        lights = core.seeded_lights(self.gen, p * n, self.device, float(self.traffic["light_z_min"]))
        self.inputs = [(self._pinned(images[k]), self._pinned(masks[k]), lights[k * n:(k + 1) * n].cpu())
                       for k in range(p)]
        self.face_px = [int(x) for x in (masks != 0).view(p, -1).sum(dim=1).tolist()]
        self.lights, self.n_inputs = n, p

    def _call(self, k: int, spans: bool) -> torch.Tensor:
        image, mask, lights = self.inputs[k]
        if not spans:
            return self.rl.relight_sweep_rendered_u8(image, mask, lights)
        with record_function("entry.relight_sweep_rendered_u8"):
            return self.rl.relight_sweep_rendered_u8(image, mask, lights)

    def _work(self, k: int):
        return self.lights, 1, self.lights * self.face_px[k]

    def _cnn_input(self) -> torch.Tensor:
        return self.inputs[0][0][None].to(self.device).float() / 255.0

    def _reference(self, k: int):
        image, mask, lights = self.inputs[k]
        img = image[None].to(self.device).float() / 255.0
        m = mask[None].to(self.device).float() / 255.0
        albedo, depth, lighting = self._net(img)
        out = []
        for s in range(0, self.lights, 16):
            n = min(16, self.lights - s)
            r = ref_render.render(albedo.expand(n, -1, -1, -1), depth.expand(n, -1, -1), lighting.expand(n, -1),
                                  m.expand(n, -1, -1), self.rcfg, target_light=lights[s:s + n].to(self.device))
            out.append(ref_render.to_u8(r["rendered"] * m[..., None]).cpu().numpy())
        face = np.broadcast_to((mask != 0).numpy()[None], (self.lights,) + tuple(mask.shape))
        return np.concatenate(out), face

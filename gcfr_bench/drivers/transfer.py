"""Lighting transfer at batch (`cli transfer`'s path): `Relighter.estimate_lighting` on
reference faces, then `Relighter.forward_visuals` on the input faces under the light
and ambient it estimated, one caller in a closed loop.

Traffic: `batch` pairs a call, `pool_batches` distinct batches made at set-up and
sent in turn. Each pair's input face is drawn by seed from the ten of the data file,
its reference from the nine others; input and reference are each moved by a seeded
jitter of at most `jitter_levels`, and the input keeps its mask. Each call uploads
the references, then the inputs and masks, as uint8 from pinned host memory, and
fetches the packed uint8 visuals (B, H, W, 12) back into it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from gcfr_bench import core
from gcfr_bench.drivers._relight import RelightDriver
from gcfr_bench.reference import transfer as ref_transfer


class Driver(RelightDriver):
    rate_metric = "relight_img_per_s"

    def _make_inputs(self) -> None:
        b, p = int(self.traffic["batch"]), int(self.traffic["pool_batches"])
        levels = int(self.traffic["jitter_levels"])
        ids = torch.randint(0, 10, (p * b,), generator=self.gen, device=self.device)
        ref_ids = (ids + torch.randint(1, 10, (p * b,), generator=self.gen, device=self.device)) % 10
        images, masks = core.jittered_faces(self.gen, ids, self.device, levels, self.size)
        refs, _ = core.jittered_faces(self.gen, ref_ids, self.device, levels, self.size)
        face_px = (masks != 0).view(p, -1).sum(dim=1).tolist()
        self.inputs = [tuple(self._pinned(x[k * b:(k + 1) * b]) for x in (images, masks, refs)) for k in range(p)]
        self.face_px = [int(f) for f in face_px]
        self.batch, self.n_inputs = b, p

    def _transfer(self, k: int) -> torch.Tensor:
        images, masks, refs = self.inputs[k]
        light, ambient = self.rl.estimate_lighting(refs)
        return self.rl.forward_visuals(images, masks, target_light=light, target_ambient=ambient)

    def _call(self, k: int, spans: bool) -> torch.Tensor:
        if not spans:
            return self._transfer(k)
        with record_function("entry.transfer"):
            return self._transfer(k)

    def _work(self, k: int):
        return self.batch, self.batch, self.face_px[k]

    def estimate_ms(self, repeats: int = 10) -> float:
        """`Relighter.estimate_lighting` alone on a pool batch's references, by CUDA events
        (ms per call)."""
        refs = self.inputs[0][2]
        for _ in range(2):
            self.rl.estimate_lighting(refs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            self.rl.estimate_lighting(refs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / repeats

    def _reference(self, k: int):
        images, masks, refs = self.inputs[k]
        out, face = [], []
        for s in range(0, self.batch, 16):
            def dev(x):
                return x[s:s + 16].to(self.device).float() / 255.0

            out.append(ref_transfer.transfer_pack(self._net, dev(images), dev(masks), dev(refs), self.rcfg)
                       .cpu().numpy())
            face.append((masks[s:s + 16] != 0).numpy())
        return np.concatenate(out), np.concatenate(face)

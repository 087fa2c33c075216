"""What the relighting drivers share: a seeded Relighter, pinned host buffers kept
by a seeded reservoir, the traced stretch, the device's record and the
reference's uint8 comparison."""

from __future__ import annotations

import math

import numpy as np
import torch

from gcfr_bench import core
from gcfr_bench.reference import model as ref_model
from gcfr_bench.reference import precision
from gcfr_bench.reference import render as ref_render


class RelightDriver:
    """Subclasses define `_make_inputs()`, `_call(k, spans)` (one timed call on input
    k, returning its output tensor), `_work(k)` ((images, cnn images, face pixels)
    of input k) and `_reference(k)` (the reference's uint8 answer for input k)."""

    def __init__(self, wl: dict, cfg: dict, seed: int, device: str):
        self.wl, self.cfg, self.seed = wl, cfg, int(seed)
        self.traffic = wl["traffic"]
        self.device = torch.device(device)
        self.rcfg = cfg["pipeline"]["render"]
        self.variant = cfg["pipeline"]["model"]["variant"]
        self.size = self.rcfg["img_height"]

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from geomconsistentfr_torch.config import from_dict
        from geomconsistentfr_torch.infer import Relighter

        self.pcfg = from_dict(self.cfg["pipeline"])
        self.state = core.seeded_state_dict(ref_model.RelightNet, self.seed, self.device, variant=self.variant)
        self.rl = Relighter(self.pcfg, self.state, device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            int(np.random.default_rng([self.seed, 1]).integers(2 ** 62)))
        self._make_inputs()
        self.kept = core.Reservoir(int(self.traffic["checked_calls"]), [self.seed, 2])
        self.free_bufs = []
        for k in range(min(2, self.n_inputs)):  # every shape the window uses, once
            self.free_bufs.append(self._fetch(self._call(k, False)))
        while len(self.free_bufs) < self.kept.k + 1:  # no host allocation inside the window
            self.free_bufs.append(torch.empty_like(self.free_bufs[0], pin_memory=self.device.type == "cuda"))
        self._sync()

    def _pinned(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu().pin_memory() if self.device.type == "cuda" else t.cpu()

    def _fetch(self, out: torch.Tensor) -> torch.Tensor:
        """The output copied into a host buffer (pinned on the card), as a batch job keeps it."""
        buf = self.free_bufs.pop() if self.free_bufs else torch.empty(
            out.shape, dtype=out.dtype, pin_memory=self.device.type == "cuda")
        buf.copy_(out)
        return buf

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        calls = images = cnn_images = face_px = 0
        t0 = core.now()
        while True:
            k = calls % self.n_inputs
            buf = self._fetch(self._call(k, False))
            dropped = self.kept.offer((k, buf))
            if dropped is not None:
                self.free_bufs.append(dropped[1])
            calls += 1
            n, c, f = self._work(k)
            images, cnn_images, face_px = images + n, cnn_images + c, face_px + f
            if core.now() - t0 >= seconds:
                break
        elapsed = core.now() - t0
        return {"metrics": {self.rate_metric: images / elapsed}, "attempted": images, "failed": 0,
                "calls": calls, "images": images, "cnn_images": cnn_images, "face_pixels": face_px,
                "seconds": elapsed}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def device_info(self) -> dict:
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device), "count": 1}

    def trace(self, window: dict):
        """A steady stretch of about two seconds of the window's own calls under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile, record_function

        n = max(3, min(400, math.ceil(2.0 * window["calls"] / window["seconds"])))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        info = {"calls": n, "images": 0, "cnn_images": 0, "face_pixels": 0}
        with profile(activities=acts) as prof:
            with record_function("stretch"):
                t0 = core.now()
                for i in range(n):
                    k = i % self.n_inputs
                    out = self._call(k, True)
                    with record_function("host.fetch"):
                        self.free_bufs.append(self._fetch(out))
                    w = self._work(k)
                    info["images"] += w[0]
                    info["cnn_images"] += w[1]
                    info["face_pixels"] += w[2]
                self._sync()
                host = core.now() - t0
        tr = core.Trace.from_profiler(prof, host)
        tr.info = info
        return tr

    def cnn_ms(self, repeats: int = 10) -> float:
        """The Relighter's CNN alone at the cell's CNN batch, by CUDA events (ms per call)."""
        from geomconsistentfr_torch.models.layers import deterministic_convs

        x = self._cnn_input()
        with torch.no_grad(), deterministic_convs():
            for _ in range(2):
                self.rl.model(x, self.rl.use_skips)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                self.rl.model(x, self.rl.use_skips)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / repeats

    # -- the check ------------------------------------------------------------
    def free(self) -> None:
        self.rl = None
        self.free_bufs = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_net(self, tf32: bool = False):
        net = ref_model.RelightNet(self.variant).to(self.device).eval()
        net.load_state_dict(self.state)
        return net

    def answers(self, tf32: bool = False):
        """The reference's uint8 answers for the kept calls, and their face masks."""
        if not tf32 and getattr(self, "_want", None) is not None:
            return self._want
        self._net = self.reference_net(tf32)
        want, face = [], []
        with torch.no_grad(), precision(tf32):
            for k, _ in self.kept.items:
                r, m = self._reference(k)
                want.append(r)
                face.append(m)
        self._net = None
        out = np.concatenate(want), np.concatenate(face)
        if not tf32:
            self._want = out
        return out

    def check(self) -> core.Verdict:
        """The kept calls' outputs against the reference's answers."""
        want, face = self.answers(False)
        got = np.concatenate([buf.numpy() for _, buf in self.kept.items])
        self.gaps = core.u8_gaps(got, want, face)
        verdict = core.Verdict()
        for name, limit in self.wl["check"].items():
            verdict.add(name, self.gaps[name], limit)
        return verdict

    def control(self) -> dict:
        """The control's numbers: the reference in TF32 in the program's place."""
        want, face = self.answers(False)
        return core.u8_gaps(self.answers(True)[0], want, face)

    def faults(self) -> dict:
        """An answer altered where it is produced: one image of the kept outputs, every byte
        moved by 64 levels (mod 256)."""
        want, face = self.answers(False)
        got = np.concatenate([buf.numpy() for _, buf in self.kept.items])
        got[0] ^= 64
        return {"answer_altered": core.u8_gaps(got, want, face)}

    def _ref_forward(self, images_u8, masks_u8, lights):
        """The reference's net and render on uint8 inputs (device tensors)."""
        img = images_u8.to(self.device).float() / 255.0
        mask = masks_u8.to(self.device).float() / 255.0
        albedo, depth, lighting = self._net(img)
        return albedo, depth, lighting, mask, ref_render.render(albedo, depth, lighting, mask, self.rcfg,
                                                               target_light=lights.to(self.device))

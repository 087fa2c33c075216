"""The detect-crop-relight batch job: `Relighter.relight_frames` on batches of uncropped
frames, one caller in a closed loop (`recrop_CelebA-HQ_images.py`'s S3FD crop of every
frame, then the relight of each crop).

Traffic: `frames` frames a call, `pool_batches` batches made at set-up from the seed and
sent in turn. A frame is `frame_size`² uint8 RGB: one of the ten faces of the data file,
upscaled (bilinear) by a seeded factor in `face_scale`, at a seeded offset, on a seeded
smooth background (a 4x4 grid of colours upscaled bilinearly), every byte then moved by a
seeded jitter of at most `jitter_levels`; its mask frame holds the face's mask upscaled
(nearest) and placed the same way. A seeded light a frame (z >= `light_z_min`). Frames
and mask frames are pinned on the host; each call uploads the frames to the detector,
crops on the host and uploads the crops, and fetches the packed uint8 visuals of the
relit crops back into pinned memory.

Weights: RelightNet as every relighting cell draws it; S3FD through `core.seeded_state_dict`
on the reference's parameter names, L2Norm at its scales, then calibrated once at set-up
as the configuration's `assumed` says, on the reference's own features of the pool's frames.

The check holds the kept calls against `reference/s3fd.py` and the relighting reference,
stage by stage (`Driver._compare`): the twelve heads (recomputed by the program at the call's
batch after the window, as a diagnostic), the timed call's candidates, NMS on them, the crops
where the geometry agrees, and the relit packs, on every frame's face.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from gcfr_bench import core
from gcfr_bench.drivers._relight import RelightDriver
from gcfr_bench.reference import model as ref_model
from gcfr_bench.reference import precision
from gcfr_bench.reference import render as ref_render
from gcfr_bench.reference import s3fd as ref_s3fd


def face_cover(mask: np.ndarray, geometry) -> float:
    """The share of the mask frame's face pixels inside the crop window `geometry` (left, top,
    side on the PAD-padded frame), 0 where there is no crop."""
    face = mask != 0
    if geometry is None or not face.any():
        return 0.0
    left, top, side = (v - ref_s3fd.PAD if i < 2 else v for i, v in enumerate(geometry))
    inside = face[max(top, 0):max(top + side, 0), max(left, 0):max(left + side, 0)]
    return float(inside.sum() / face.sum())


class Fetched:
    """A call's answer on the host: its packs in a pinned buffer of the batch's size, how many
    rows are filled, each row's frame, each frame's kept boxes and the call's candidate rows."""

    def __init__(self, pack: torch.Tensor):
        self.pack, self.n, self.index, self.boxes, self.candidates = pack, 0, None, None, None

    def visuals(self) -> np.ndarray:
        return self.pack[: self.n].numpy()


class Driver(RelightDriver):
    rate_metric = "relight_img_per_s"

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from geomconsistentfr_torch import preprocess
        from geomconsistentfr_torch.config import from_dict
        from geomconsistentfr_torch.infer import Relighter
        from geomconsistentfr_torch.models import s3fd

        if not hasattr(preprocess, "detect_faces_s3fd_batch") or not hasattr(Relighter, "relight_frames"):
            raise RuntimeError("the program has no batched detect-crop-relight path (preprocess."
                               "detect_faces_s3fd_batch, Relighter.relight_frames): it cannot run this cell")
        self.pcfg = from_dict(self.cfg["pipeline"])
        self.state = core.seeded_state_dict(ref_model.RelightNet, self.seed, self.device, variant=self.variant)
        self.rl = Relighter(self.pcfg, self.state, device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            int(np.random.default_rng([self.seed, 1]).integers(2 ** 62)))
        self._make_inputs()
        self.s3fd_state = self._calibrated_s3fd()
        self.detector = s3fd.S3FD().to(self.device)
        self.detector.load_state_dict(self.s3fd_state)
        self.kept = core.Reservoir(int(self.traffic["checked_calls"]), [self.seed, 2])
        self.free_bufs, self.work = [], []
        for k in range(self.n_inputs):  # every batch once: the crops' count, so the tail's shapes, varies
            rec = self._fetch(self._call(k, False))
            self.work.append(self._count_work(k, rec))
            self.free_bufs.append(rec)
        while len(self.free_bufs) < self.kept.k + 1:  # no host allocation inside the window
            self.free_bufs.append(self._new_record())
        self._sync()

    def _make_inputs(self) -> None:
        t = self.traffic
        b, p, size = int(t["frames"]), int(t["pool_batches"]), int(t["frame_size"])
        lo, hi = (float(v) for v in t["face_scale"])
        n = b * p
        rng = np.random.default_rng([self.seed, 4])
        faces = core.faces(self.device)
        src = faces["image"].shape[1]
        ids = rng.integers(0, 10, n)
        sides = np.minimum(np.rint(src * rng.uniform(lo, hi, n)).astype(int), size)
        tops = [int(rng.integers(0, size - s + 1)) for s in sides]
        lefts = [int(rng.integers(0, size - s + 1)) for s in sides]
        grid = torch.rand((n, 3, 4, 4), generator=self.gen, device=self.device) * 255.0
        frames = F.interpolate(grid, size=(size, size), mode="bilinear", align_corners=True)
        masks = torch.zeros((n, 1, size, size), device=self.device)
        for i in range(n):
            s, y, x = int(sides[i]), tops[i], lefts[i]
            face = faces["image"][int(ids[i])].permute(2, 0, 1)[None].float()
            mask = faces["mask"][int(ids[i])][None, None].float()
            frames[i:i + 1, :, y:y + s, x:x + s] = F.interpolate(face, size=(s, s), mode="bilinear",
                                                                 align_corners=False)
            masks[i:i + 1, :, y:y + s, x:x + s] = F.interpolate(mask, size=(s, s), mode="nearest")
        frames = frames.round().to(torch.int16).permute(0, 2, 3, 1)
        levels = int(t["jitter_levels"])
        noise = torch.randint(-levels, levels + 1, frames.shape, generator=self.gen, device=self.device,
                              dtype=torch.int16)
        frames = (frames + noise).clamp_(0, 255).to(torch.uint8).contiguous()  # (B, H, W, 3) in memory too
        masks = masks[:, 0].to(torch.uint8)
        lights = core.seeded_lights(self.gen, n, self.device, float(t["light_z_min"]))
        self.inputs = [(self._pinned(frames[k * b:(k + 1) * b]), self._pinned(masks[k * b:(k + 1) * b]),
                        lights[k * b:(k + 1) * b].cpu()) for k in range(p)]
        self.squares = list(zip(tops, lefts, sides.tolist()))  # each pool frame's face: (top, left, side)
        self.batch, self.n_inputs, self.frame_size = b, p, size

    def _calibrated_s3fd(self) -> dict:
        """The seeded S3FD state, calibrated on the reference's features (float32, TF32 off) of
        the pool's frames. Random weights score every anchor near 0.5 by its place on the map
        (the zero padding at the map's edges decides), not by what it sees, so every anchor
        would reach the NMS and the boxes would fall off the faces:
          * the four finer heads' face bias -100: their anchors of 16-128 px fall below the
            crop's 200 px minimum, so they never fire;
          * the two coarsest heads' scores fitted (`_fit_scores`) to the placed faces;
          * one shift of their face bias, which puts the weakest pool frame's best anchor at
            the face score sigmoid(`calibration_margin`);
          * their offset biases: a box on its anchor, as wide and high as the pool's mean face
            box (the box whose crop is a placed face's square); the seeded offset weights stay.
        The candidates, the kept boxes and the share of the face's mask pixels that the crop of
        the largest kept box holds, a frame, are kept for the result line (`device_info`)."""
        seed = int(np.random.default_rng([self.seed, 3]).integers(2 ** 62))
        state = core.seeded_state_dict(ref_s3fd.S3FD, seed, self.device)
        for key, (c, scale) in ref_s3fd.l2norm_keys().items():
            state[key] = torch.full((c,), scale, device=self.device)
        names = [ref_s3fd.head_name(src, scale) for src, _, _, scale in ref_s3fd.HEADS]
        for i, name in enumerate(names[:4]):
            state[f"{name}_mbox_conf.bias"][3 if i == 0 else 1] -= 100.0
        outs, coarse = [], []
        with torch.no_grad(), precision(False):
            for frames, _, _ in self.inputs:
                for frame in frames.numpy():
                    feats = ref_s3fd.features(state, ref_s3fd.detector_input(frame, self.device))
                    outs.append([h.cpu() for h in ref_s3fd.head_outputs(state, feats)[:8]])
                    coarse.append([feats[name] for name in names[4:]])
            for j, name in enumerate(names[4:]):
                self._fit_scores(state, name, ref_s3fd.HEADS[4 + j][2], [f[j] for f in coarse])
            best = min(max(float((c[..., 1] - c[..., 0]).max())
                           for c in (ref_s3fd.scores(state, name, f[j]) for j, name in enumerate(names[4:])))
                       for f in coarse)
            shift = float(self.traffic["calibration_margin"]) - best
            box = float(np.mean([sq for _, _, sq in self.squares])) / ref_s3fd.SCALE
            for j, name in enumerate(names[4:]):
                side = 4.0 * ref_s3fd.HEADS[4 + j][2]
                state[f"{name}_mbox_conf.bias"][1] += shift
                state[f"{name}_mbox_loc.bias"] = torch.tensor(
                    [0.0, -ref_s3fd.CENTRE_SHIFT * box / (ref_s3fd.VARIANCES[0] * side)]
                    + [float(np.log(box / side)) / ref_s3fd.VARIANCES[1]] * 2, device=self.device)
            for o, f in zip(outs, coarse):
                for j, name in enumerate(names[4:]):
                    o += [ref_s3fd.scores(state, name, f[j]).cpu(), ref_s3fd.offsets(state, name, f[j]).cpu()]
        cands, kept, cover = [], [], []
        masks = [m for _, batch, _ in self.inputs for m in batch.numpy()]
        for o, mask in zip(outs, masks):
            c = ref_s3fd.candidates(o)
            boxes = ref_s3fd.kept(c)
            boxes[:, :4] -= ref_s3fd.PAD
            cands.append(len(c))
            kept.append(len(boxes))
            cover.append(face_cover(mask, ref_s3fd.crop_geometry(ref_s3fd.largest(boxes)) if len(boxes) else None))
        self.calibration = {"face_shift": shift, "candidates_per_frame": cands, "kept_per_frame": kept,
                            "face_cover_per_frame": cover}
        return state

    def _fit_scores(self, state: dict, name: str, stride: int, feats: list) -> None:
        """Detection layer `name`'s score convolution, its face score fitted by ridge regression
        (float64, ridge 1e-7 of the normal matrix's mean diagonal) on its features `feats` of
        the pool's frames: +1 at the anchors whose centre lies within a stride of the placed
        face's centre, -1 elsewhere; its background score 0."""
        c = feats[0].shape[1]
        normal = torch.zeros((9 * c + 1, 9 * c + 1), dtype=torch.float64, device=self.device)
        rhs = torch.zeros(9 * c + 1, dtype=torch.float64, device=self.device)
        for f, (top, left, sq) in zip(feats, self.squares):
            x = F.unfold(f.double(), 3, padding=1)[0].T  # (positions, c * 9): the weight's own order
            x = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
            h, w = f.shape[2:]
            ys, xs = torch.meshgrid(torch.arange(h, device=self.device), torch.arange(w, device=self.device),
                                    indexing="ij")
            dx = (xs.reshape(-1).double() + 0.5) * stride - (left + sq / 2 + ref_s3fd.PAD)
            dy = (ys.reshape(-1).double() + 0.5) * stride - (top + sq / 2 + ref_s3fd.PAD)
            y = torch.where(torch.hypot(dx, dy) < stride, 1.0, -1.0).double()
            normal += x.T @ x
            rhs += x.T @ y
        ridge = 1e-7 * torch.diagonal(normal).mean()
        sol = torch.linalg.solve(normal + ridge * torch.eye(9 * c + 1, dtype=torch.float64, device=self.device), rhs)
        weight = torch.zeros((2, c, 3, 3), dtype=torch.float64, device=self.device)
        weight[1] = sol[:-1].reshape(c, 3, 3)
        state[f"{name}_mbox_conf.weight"] = weight.float()
        state[f"{name}_mbox_conf.bias"] = torch.stack([torch.zeros_like(sol[-1]), sol[-1]]).float()

    def _new_record(self) -> Fetched:
        s = self.pcfg.render.img_height
        return Fetched(torch.empty((self.batch, s, s, 12), dtype=torch.uint8, pin_memory=self.device.type == "cuda"))

    def _fetch(self, out) -> Fetched:
        rec = self.free_bufs.pop() if self.free_bufs else self._new_record()
        rec.n = int(out.visuals.shape[0])
        rec.pack[: rec.n].copy_(out.visuals)
        rec.index, rec.boxes, rec.candidates = out.frame_index, out.boxes, out.candidates
        return rec

    def _count_work(self, k: int, rec: Fetched):
        """(crops relit, crops through the CNN, their face pixels) of batch k, the face pixels
        from the reference's crop of the mask frames at the program's largest boxes."""
        _, masks, _ = self.inputs[k]
        s = self.pcfg.render.img_height
        face = 0
        for b in rec.index:
            g = ref_s3fd.crop_geometry(ref_s3fd.largest(rec.boxes[b]))
            if g is not None:
                face += int((ref_s3fd.crop(masks[b].numpy(), g, s) != 0).sum())
        return rec.n, rec.n, face

    def _call(self, k: int, spans: bool):
        frames, masks, lights = self.inputs[k]
        if not spans:
            return self.rl.relight_frames(frames, masks, self.detector, target_light=lights)
        with record_function("entry.relight_frames"):
            return self.rl.relight_frames(frames, masks, self.detector, target_light=lights)

    def _work(self, k: int):
        return self.work[k]

    def device_info(self) -> dict:
        return {**super().device_info(), "s3fd_calibration": self.calibration}

    def trace(self, window: dict):
        """The traced stretch, with the program's counters' change over it (`info['counts']`)."""
        from geomconsistentfr_torch.utils import profiling

        before = dict(getattr(profiling, "COUNTS", {}))
        tr = super().trace(window)
        tr.info["counts"] = {k: v - before.get(k, 0) for k, v in getattr(profiling, "COUNTS", {}).items()}
        return tr

    # -- the check ------------------------------------------------------------
    def free(self) -> None:
        """The program's heads of the kept calls' frames, recomputed by its own function at the
        call's batch after the window (the stage-wise diagnostic: the candidates and everything
        after them that the check compares are the timed calls' own), then the program's state
        dropped."""
        if getattr(self, "detector", None) is not None and getattr(self, "kept", None) is not None:
            from geomconsistentfr_torch.preprocess import s3fd_heads_batch

            self.program_heads = [[h.cpu() for h in s3fd_heads_batch(self.inputs[k][0], self.detector)]
                                  for k, _ in self.kept.items]
        self.detector = None
        super().free()

    def _frames(self):
        """(call, frame index, frame, mask frame, light) of each frame of the kept calls, in order."""
        for k, _ in self.kept.items:
            frames, masks, lights = self.inputs[k]
            for b in range(self.batch):
                yield k, b, frames[b].numpy(), masks[b].numpy(), lights[b:b + 1]

    def _reference_heads(self, tf32: bool) -> dict:
        """Each kept frame's reference heads and candidates (float32, or TF32 for the control),
        and the largest gap of each head to the program's (float32) or to the float32
        reference's (TF32), over that head's largest magnitude."""
        if not tf32 and getattr(self, "_ref", None) is not None:
            return self._ref
        worst, scale, heads_out, cands = np.zeros(12), np.zeros(12), [], []
        with torch.no_grad(), precision(tf32):
            for j, (k, b, frame, _, _) in enumerate(self._frames()):
                heads = ref_s3fd.heads(self.s3fd_state, ref_s3fd.detector_input(frame, self.device))
                if tf32:
                    against = self._ref["heads"][j]
                else:
                    against = [h[b:b + 1] for h in self.program_heads[j // self.batch]]
                for i, h in enumerate(heads):
                    worst[i] = max(worst[i], float((against[i].to(self.device) - h).abs().max()))
                    scale[i] = max(scale[i], float(h.abs().max()))
                heads_out.append(None if tf32 else [h.cpu() for h in heads])
                cands.append(ref_s3fd.candidates(heads))
        out = {"heads_rel_gap": float(np.max(worst / np.maximum(scale, 1e-30))), "heads": heads_out,
               "cands": cands}
        if not tf32:
            self._ref = out
        return out

    def _relit(self, crop: np.ndarray, mask: np.ndarray, light, tf32: bool) -> np.ndarray:
        """The relighting reference's pack of one crop (float32, or TF32 for the control)."""
        with torch.no_grad(), precision(tf32):
            albedo, depth, _, m, r = self._ref_forward(torch.from_numpy(crop[None]), torch.from_numpy(mask[None]),
                                                       light)
            return ref_render.visual_pack(albedo, depth, r, m).cpu().numpy()[0]

    def _program_answers(self, items) -> list:
        """The program's answer for each frame of the kept calls `items` ((k, Fetched)), all the
        timed call's own: its candidates, its kept boxes, the crop geometry of the largest and,
        where it crops, the crops of the frame and its mask (the program's crop of the call's
        boxes) and the call's pack row."""
        from geomconsistentfr_torch.preprocess import crop_face, crop_geometry, largest_box

        s = self.pcfg.render.img_height
        out = []
        for k, rec in items:
            frames, masks, _ = self.inputs[k]
            rows = {int(b): i for i, b in enumerate(rec.index)}
            visuals = rec.visuals()
            for b, boxes in enumerate(rec.boxes):
                box = largest_box([tuple(float(v) for v in d[:4]) for d in boxes])
                row = {"cands": rec.candidates[rec.candidates[:, 0] == b, 1:], "boxes": boxes,
                       "geometry": None if box is None else crop_geometry(box)}
                if row["geometry"] is not None:
                    row["crop"] = crop_face(frames[b].numpy(), box, s)
                    row["mask"] = crop_face(masks[b].numpy(), box, s)
                    row["pack"] = visuals[rows[b]] if b in rows else np.zeros((s, s, 12), np.uint8)
                out.append(row)
        return out

    def _control_answers(self) -> tuple:
        """The control's answers: the reference in TF32 in the program's place, end to end (its
        candidates, its NMS, its crop of its largest box, its relight of that crop in TF32)."""
        ctrl = self._reference_heads(True)
        s = self.pcfg.render.img_height
        out = []
        self._net = self.reference_net()
        for cands, (_, _, frame, mask, light) in zip(ctrl["cands"], self._frames()):
            boxes = ref_s3fd.kept(cands)
            boxes[:, :4] -= ref_s3fd.PAD
            g = ref_s3fd.crop_geometry(ref_s3fd.largest(boxes)) if len(boxes) else None
            row = {"cands": cands, "boxes": boxes, "geometry": g}
            if g is not None:
                row["crop"], row["mask"] = ref_s3fd.crop(frame, g, s), ref_s3fd.crop(mask, g, s)
                row["pack"] = self._relit(row["crop"], row["mask"], light, True)
            out.append(row)
        self._net = None
        return ctrl["heads_rel_gap"], out

    def _compare(self, answers: list, heads_gap: float) -> dict:
        """The numbers the check compares, stage by stage, of each frame's answer against the
        float32 references:
          * the heads' gap (`heads_gap`);
          * the candidates (every anchor past 0.05, in decode order) against the reference's:
            the largest gap of a coordinate (padded pixels);
          * NMS and the 0.5 keep: the answer's kept boxes, bit for bit, against the reference's
            NMS of the answer's own candidates (with random weights every anchor scores near
            0.5, and NMS on two sets of candidates a rounding apart keeps other boxes: it is
            compared on one);
          * the crop: the answer's geometry and bytes, of the frame and of its mask, against the
            reference's crop of the answer's largest box; the packs against the relighting
            reference's of that crop, over its face pixels, and off them (0 by construction);
          * the frames compared whose answer gives no crop or a crop without a face pixel
            (`frames_off_face`): the calibration puts every frame's largest kept box on its
            face, so the packs are compared on every frame.
        A frame whose candidates or kept boxes differ where a score lies within `tie_delta` of
        0.05 or 0.5, or where NMS meets a near tie (`s3fd.near_tie`), or whose geometry differs
        (a truncation at an integer on the other side), is set apart and counted; any other
        difference counts as a frame differing."""
        delta = float(self.wl["tie_delta"])
        ref = self._reference_heads(False)
        s = self.pcfg.render.img_height
        cand_gap, differing, apart, crop_off, off_face, no_face = 0.0, 0, 0, 0, 0, 0
        got, want, face = [], [], []
        self._net = self.reference_net()
        for ans, truth, (_, _, frame, mask, light) in zip(answers, ref["cands"], self._frames()):
            mine = ans["cands"]
            if len(mine) != len(truth):
                near = np.any(np.abs(truth[:, 4] - ref_s3fd.CANDIDATE) < delta)
                apart, differing = apart + near, differing + (not near)
                continue
            if len(mine):
                cand_gap = max(cand_gap, float(np.abs(mine[:, :4] - truth[:, :4]).max()))
            kept = ref_s3fd.kept(mine)
            kept[:, :4] -= ref_s3fd.PAD
            if not np.array_equal(ans["boxes"], kept):
                near = ref_s3fd.near_tie(mine.astype(np.float64), delta)
                apart, differing = apart + near, differing + (not near)
                continue
            boxes = np.asarray(ans["boxes"], np.float64)
            g = ref_s3fd.crop_geometry(ref_s3fd.largest(boxes)) if len(boxes) else None
            if g != ans["geometry"]:
                apart += 1
                continue
            if g is None:
                no_face += 1
                continue
            crop, mcrop = ref_s3fd.crop(frame, g, s), ref_s3fd.crop(mask, g, s)
            crop_off += int(np.count_nonzero(ans["crop"] != crop)) + int(np.count_nonzero(ans["mask"] != mcrop))
            pack = self._relit(crop, mcrop, light, False)
            on_face = mcrop != 0
            off_face += int(np.count_nonzero((ans["pack"] != pack) & ~on_face[..., None]))
            if on_face.any():
                got.append(ans["pack"])
                want.append(pack)
                face.append(on_face)
            else:
                no_face += 1
        self._net = None
        gaps = {"heads_rel_gap": heads_gap, "cand_px_gap": cand_gap, "frames_differing": float(differing),
                "frames_set_apart": apart / max(len(answers), 1), "crop_bytes_off": float(crop_off),
                "pack_bytes_off_face": float(off_face), "frames_off_face": float(no_face),
                "crops_with_face": float(len(got))}
        if got:
            gaps.update(core.u8_gaps(np.stack(got), np.stack(want), np.stack(face)))
        else:
            gaps.update({k: 0.0 for k in ("worst_image_off_by_2", "mean_gap", "moved_share")})
        return gaps

    def check(self) -> core.Verdict:
        ref = self._reference_heads(False)
        self.gaps = self._compare(self._program_answers(self.kept.items), ref["heads_rel_gap"])
        verdict = core.Verdict()
        for name, limit in self.wl["check"].items():
            verdict.add(name, self.gaps[name], limit)
        return verdict

    def control(self) -> dict:
        """The control's numbers: the reference in TF32 in the program's place."""
        heads_gap, answers = self._control_answers()
        return self._compare(answers, heads_gap)

    def faults(self) -> dict:
        """An answer altered where it is produced: one kept call's packs, every byte moved by 64
        levels (mod 256)."""
        (k, rec), rest = self.kept.items[0], self.kept.items[1:]
        altered = Fetched(rec.pack.clone())
        altered.n, altered.index, altered.boxes, altered.candidates = rec.n, rec.index, rec.boxes, rec.candidates
        altered.pack[: altered.n] ^= 64
        ref = self._reference_heads(False)
        return {"answer_altered": self._compare(self._program_answers([(k, altered)] + rest), ref["heads_rel_gap"])}

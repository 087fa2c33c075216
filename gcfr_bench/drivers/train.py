"""The training step as `cli train` takes it: `Trainer.run_epoch`, the whole set resident
on the device, on a data provider of the benchmark's own.

Traffic: `steps_per_epoch` batches an epoch of `batch` rows (the
configuration's batch size); the provider holds `steps_per_epoch * batch`
seeded variants of the ten faces of the data file (a jitter of at most
`jitter_levels`), each with its face's reference albedo and depth as pseudo
ground truth and a seeded light (z >= `light_z_min`). Epochs are numbered
from `first_epoch` (past 14, so every skip gate is open), each visits every
batch slot once in an order drawn from the seed, and they repeat until the
window ends. No checkpoint falls inside the window: the configuration saves
every `checkpoint_every_steps` steps of an epoch, more than an epoch here has.

Set-up drives the same TrainState through the window's own call and feed for
its first three steps, then one whole epoch (the last three slots of the first epoch: nine rows,
all different), recording each step's losses, the first step's gradients as
Adam's moments give them, and the parameters after the third. After the
window the plain reference follows the same three steps from the same
weights on the same rows, and `correct` compares the two.
"""

from __future__ import annotations

import shutil

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gcfr_bench import core
from gcfr_bench.reference import model as ref_model
from gcfr_bench.reference import precision
from gcfr_bench.reference import train as ref_train

FIRST_STEPS = 3
BETA1 = 0.9


class Provider:
    """Whole-set access (`get_batch_raw`, `num_samples`) and the reference's epoch
    structure (`epoch_batch_indices`: shuffled contiguous slots). Counts the face
    pixels of every batch it hands out."""

    def __init__(self, fields: dict, face_px: np.ndarray):
        self.fields, self.face_px = fields, face_px
        self.num_samples = len(face_px)
        self.served_face_px = 0

    def get_batch_raw(self, indices) -> dict:
        return {k: v[np.asarray(indices)] for k, v in self.fields.items()}

    def epoch_batch_indices(self, rng: np.random.Generator, batch_size: int, batches_per_epoch: int):
        slots = np.arange(self.num_samples // batch_size)
        rng.shuffle(slots)
        for slot in slots[:batches_per_epoch]:
            idx = np.arange(slot * batch_size, (slot + 1) * batch_size)
            self.served_face_px += int(self.face_px[idx].sum())
            yield idx


def make_fields(gen, n: int, device, levels: int, z_min: float, size: int):
    """The provider's host arrays, in the stored dtypes of a CelebA-HQ build cache."""
    ids = torch.randint(0, 10, (n,), generator=gen, device=device)
    images, masks = core.jittered_faces(gen, ids, device, levels, size)
    f = core.faces(device, size)
    on = masks != 0
    fields = {
        "image": images,
        "depth_gt": f["depth"][ids].float(),
        "depth_mask": on.to(torch.uint8) * 255,
        "albedo_gt": f["albedo_gray"][ids],
        "face_mask": masks,
        "light_gt": core.seeded_lights(gen, n, device, z_min),
    }
    return {k: v.cpu().numpy() for k, v in fields.items()}, on.view(n, -1).sum(dim=1).cpu().numpy()


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Per leaf, |got - want| / max(want, the median leaf's want)."""
    names = [k for k in want if keep is None or k in keep]
    med = float(np.median([want[k] for k in names]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in names}


class Driver:
    def __init__(self, wl: dict, cfg: dict, seed: int, device: str):
        self.wl, self.cfg, self.seed = wl, cfg, int(seed)
        self.traffic = wl["traffic"]
        self.device = torch.device(device)
        self.pipe = cfg["pipeline"]
        self.variant = self.pipe["model"]["variant"]
        self.size = self.pipe["render"]["img_height"]
        self.steps_per_epoch = int(self.traffic["steps_per_epoch"])

    def _rng(self, epoch: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, epoch])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from geomconsistentfr_torch.config import from_dict
        from geomconsistentfr_torch.train import Trainer

        pcfg = from_dict(self.pipe)
        self.batch = pcfg.train.batch_size
        gen = torch.Generator(device=self.device).manual_seed(
            int(np.random.default_rng([self.seed, 1]).integers(2 ** 62)))
        fields, face_px = make_fields(gen, self.steps_per_epoch * self.batch, self.device,
                                      int(self.traffic["jitter_levels"]), float(self.traffic["light_z_min"]),
                                      self.size)
        self.provider = Provider(fields, face_px)
        self.g_sd = core.seeded_state_dict(ref_model.RelightNet, self.seed, self.device, variant=self.variant)
        self.d_sd = core.seeded_state_dict(ref_model.PatchGAN, self.seed + 1, self.device)
        self.workdir = core.scratch_dir()
        self.trainer = Trainer(pcfg, data=self.provider, workdir=self.workdir, device=self.device)
        if pcfg.train.checkpoint_every_steps <= self.steps_per_epoch:
            raise ValueError("a checkpoint would fall inside the window")
        self.state = self.trainer.init_or_resume()
        self.state.g.load_state_dict(self.g_sd)
        self.state.d.load_state_dict(self.d_sd)
        self.first_epoch = self.epoch = int(self.traffic["first_epoch"])
        self._first_steps()
        if self.trainer._resident() is None:
            raise RuntimeError("the training set did not go resident on the device")
        self._epoch()  # one whole epoch, as the window runs them

    def _first_steps(self) -> None:
        """The first three steps through run_epoch, recorded for the check."""
        step_fn, losses, first = self.trainer.step_fn, [], {}

        def recording(state, batch, use_skips):
            m = step_fn(state, batch, use_skips=use_skips)
            losses.append({k: float(m[k]) for k in ("total", "discriminator")})
            if len(losses) == 1:
                for tag, opt, net in (("g", state.opt_g, state.g), ("d", state.opt_d, state.d)):
                    first[tag] = leaf_norms({n: opt.state[p]["exp_avg"] / (1.0 - BETA1)
                                             for n, p in net.named_parameters()})
            return m

        self.trainer.step_fn = recording
        try:
            self.trainer.run_epoch(self.state, self.epoch, rng=self._rng(self.epoch),
                                   start_batch=self.steps_per_epoch - FIRST_STEPS)
        finally:
            self.trainer.step_fn = step_fn
        self.first_indices = list(self.provider.epoch_batch_indices(
            self._rng(self.epoch), self.batch, self.steps_per_epoch))[-FIRST_STEPS:]
        self.program = {"losses": losses, "grads": first,
                        "change": {"g": self._change(self.state.g, self.g_sd), "d": self._change(self.state.d, self.d_sd)}}
        self.epoch += 1
        self._sync()

    @staticmethod
    def _change(net, start: dict) -> dict:
        with torch.no_grad():
            return leaf_norms({n: p - start[n] for n, p in net.named_parameters()})

    # -- the window -----------------------------------------------------------
    def _epoch(self) -> int:
        """One epoch; the steps whose epoch's mean loss is not finite."""
        _, avg = self.trainer.run_epoch(self.state, self.epoch, rng=self._rng(self.epoch))
        self.epoch += 1
        self._sync()
        return 0 if np.isfinite(avg.get("total", np.nan)) else self.steps_per_epoch

    def window(self, seconds: float) -> dict:
        self.provider.served_face_px = 0
        steps = failed = 0
        t0 = core.now()
        while True:
            failed += self._epoch()
            steps += self.steps_per_epoch
            if core.now() - t0 >= seconds:
                break
        elapsed = core.now() - t0
        return {"metrics": {"train_step_ms": 1e3 * elapsed / steps}, "attempted": steps, "failed": failed,
                "steps": steps, "face_pixels": self.provider.served_face_px, "seconds": elapsed}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def device_info(self) -> dict:
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device), "count": 1}

    def trace(self, window: dict):
        """One epoch under torch.profiler, each step inside a span of the benchmark's own."""
        step_fn = self.trainer.step_fn

        def spanned(state, batch, use_skips):
            with record_function("entry.train_step"):
                return step_fn(state, batch, use_skips=use_skips)

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.trainer.step_fn = spanned
        try:
            with profile(activities=acts) as prof:
                with record_function("stretch"):
                    t0 = core.now()
                    with record_function("entry.run_epoch"):
                        self._epoch()
                    host = core.now() - t0
        finally:
            self.trainer.step_fn = step_fn
        tr = core.Trace.from_profiler(prof, host)
        tr.info = {"calls": self.steps_per_epoch}
        return tr

    # -- the check ------------------------------------------------------------
    def free(self) -> None:
        self.trainer = self.state = None
        if getattr(self, "workdir", None):
            shutil.rmtree(self.workdir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _batch(self, idx) -> dict:
        """A batch of the provider's stored rows as the reference takes it (float32)."""
        out = {}
        for k, v in self.provider.get_batch_raw(idx).items():
            t = torch.as_tensor(v).to(self.device)
            out[k] = t.float() / 255.0 if t.dtype == torch.uint8 else t.float()
        return out

    def reference(self, tf32: bool = False, rows=None, dtype=torch.float32) -> dict:
        """The reference's three steps on the first steps' rows (`rows` keeps part of each
        batch; `dtype` float64 gives a witness)."""
        g = ref_model.RelightNet(self.variant).to(self.device, dtype).train()
        d = ref_model.PatchGAN().to(self.device, dtype).train()
        g.load_state_dict(self.g_sd)
        d.load_state_dict(self.d_sd)
        lr = self.pipe["train"]["learning_rate"]
        opt_g, opt_d = ref_train.adam(g.parameters(), lr), ref_train.adam(d.parameters(), lr)
        gates = tuple(self.first_epoch > e for e in self.pipe["model"]["skip_gate_epochs"])
        losses, grads = [], {}
        with precision(tf32):
            for i, idx in enumerate(self.first_indices):
                batch = {k: v.to(dtype) for k, v in self._batch(idx if rows is None else idx[rows]).items()}
                losses.append(ref_train.step(g, d, opt_g, opt_d, i, batch, self.pipe["render"],
                                             self.pipe["train"]["loss"], self.pipe["train"]["gd_ratio"], gates))
                if i == 0:
                    for tag, opt, net in (("g", opt_g, g), ("d", opt_d, d)):
                        grads[tag] = leaf_norms({n: opt.state[p]["exp_avg"] / (1.0 - BETA1)
                                                 for n, p in net.named_parameters()})
        return {"losses": losses, "grads": grads, "change": {"g": self._change(g, self.g_sd), "d": self._change(d, self.d_sd)}}

    @staticmethod
    def numbers(got: dict, want: dict) -> dict:
        """The gaps between two runs of the first three steps. A leaf's gap is |got - want|
        over the larger of the reference's norm of that leaf and of the median leaf.

        first_loss_gap: the first step's larger relative gap of the generator's and the
        discriminator's loss; loss_gap: the same over the three steps; grad_gap: the worst
        leaf's gap of the first gradient's norm; median_grad_gap: the larger of the
        generator's and the discriminator's median leaf's gap of it, each network's median
        taken over its own leaves (the generator has many more, so one median over both
        would never see the discriminator); change_gap and median_change_gap: the same of
        the parameters' change over the three steps, over leaves whose reference gradient
        is at least a thousandth of that network's median leaf's. Each network's own
        medians are kept beside them (`median_grad_gap_g`, `_d`; `median_change_gap_g`, `_d`).
        """
        rel = [max(abs(a[k] - b[k]) / abs(b[k]) for k in b) for a, b in zip(got["losses"], want["losses"])]
        out = {"first_loss_gap": rel[0], "loss_gap": max(rel)}
        grad, change = {}, {}
        for tag in ("g", "d"):
            wg = want["grads"][tag]
            med = float(np.median(list(wg.values())))
            moved = {k for k, v in wg.items() if v >= 1e-3 * med}
            grad[tag] = list(leaf_gaps(got["grads"][tag], wg).values())
            change[tag] = list(leaf_gaps(got["change"][tag], want["change"][tag], moved).values())
        for name, gaps in (("grad", grad), ("change", change)):
            for tag in ("g", "d"):
                out[f"median_{name}_gap_{tag}"] = float(np.median(gaps[tag]))
            out[f"{name}_gap"] = max(max(v) for v in gaps.values())
            out[f"median_{name}_gap"] = max(out[f"median_{name}_gap_g"], out[f"median_{name}_gap_d"])
        return out

    def check(self) -> core.Verdict:
        self.want = self.reference(False)
        self.gaps = self.numbers(self.program, self.want)
        verdict = core.Verdict()
        for name, limit in self.wl["check"].items():
            verdict.add(name, self.gaps[name], limit)
        return verdict

    def control(self) -> dict:
        """The reference in TF32 in the program's place."""
        return self.numbers(self.reference(True), self.want)

    def faults(self) -> dict:
        """A fault of the step planted in the reference put in the program's place:
        half of each batch left out, the mean taken over the rest. (A state left
        unchanged reads 1 on change_gap by its definition and needs no run.)"""
        return {"half_batch": self.numbers(self.reference(False, rows=slice(0, self.batch - self.batch // 2)),
                                           self.want)}

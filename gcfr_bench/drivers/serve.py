"""Interactive users of the HTTP server: `python -m geomconsistentfr_torch.serve` in a
process of its own, driven by an open loop of Poisson arrivals.

Traffic: `rate_per_s` requests a second for the window, as `round(rate *
seconds)` arrivals whose exponential gaps are scaled to fill the window
(every seed offers the same load, in another order). Below the server's
capacity the tail (`serve_p95_ms`) is what users feel; above it the requests
completed inside the window a second (`serve_req_per_s`). Each request is a
/relight with a base64 PNG face and mask drawn by seed from `payloads`
distinct ones made and encoded at set-up (the ten faces of the data file, a
jitter of at most `jitter_levels`, each face's mask) and a seeded light
(z >= `light_z_min`); the reply is two PNGs. Each request is timed from when
it was due to when its whole reply was read; a failed or refused one counts
as missing every limit. `workers` client threads send; how late they send
goes to standard error.

The server runs the configuration file's pipeline (`--config`, `--preset`,
`--precision`) with `--max-batch`, `--warmup` and `--port 0`, from a .pth of
the run's seeded weights in the run's scratch directory; it is stopped with
SIGTERM and waited for after the window. Its /statz counters are read
before and after the window.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from gcfr_bench import core, png
from gcfr_bench.reference import model as ref_model
from gcfr_bench.reference import precision
from gcfr_bench.reference import render as ref_render

TRACE_SECONDS = 5.0


class Driver:
    traced = False  # set before set-up: a traced run profiles the server over its window

    def __init__(self, wl: dict, cfg: dict, seed: int, device: str):
        self.wl, self.cfg, self.seed = wl, cfg, int(seed)
        self.traffic = wl["traffic"]
        self.device = torch.device(device)
        self.rcfg = cfg["pipeline"]["render"]
        self.variant = cfg["pipeline"]["model"]["variant"]
        self.size = self.rcfg["img_height"]
        self.proc = None

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        """Weights and payloads on the host (this process keeps off the card while the
        server holds it), then the server, then a few requests through the whole path."""
        self.dir = core.scratch_dir()
        self.state = core.seeded_state_dict(ref_model.RelightNet, self.seed, "cpu", variant=self.variant)
        ckpt = os.path.join(self.dir, "weights.pth")
        torch.save(self.state, ckpt)
        cfg_path = os.path.join(self.dir, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(self.cfg["pipeline"], f)
        self._make_payloads()
        self.record = os.path.join(self.dir, "server.json")
        t = self.traffic
        cmd = [sys.executable, "-m", "gcfr_bench.drivers.serve_child", self.record,
               *(["--profile"] if self.traced and self.device.type == "cuda" else []), "--",
               "--checkpoint", ckpt, "--config", cfg_path, "--preset", self.cfg["preset"],
               "--precision", self.cfg["tier"], "--max-batch", str(t["max_batch"]), "--warmup", "--port", "0"]
        if self.device.type != "cuda":
            cmd += ["--device", "cpu"]
        self.proc = subprocess.Popen(cmd, cwd=str(core.ROOT), stdout=subprocess.PIPE, text=True)
        self.lines = queue.Queue()
        threading.Thread(target=self._read_stdout, daemon=True).start()
        while True:
            line = self.lines.get(timeout=600)
            if line is None:
                raise RuntimeError(f"the server exited with {self.proc.wait()} before serving")
            msg = json.loads(line)
            if "serving" in msg:
                self.host, self.port = msg["serving"].split("//")[1].split(":")
                self.port = int(self.port)
                break
        for i in range(2 * int(t["max_batch"])):  # the handlers, the codec and both batch sizes, warm
            status, _ = self._post(i % len(self.bodies))
            if status != 200:
                raise RuntimeError(f"a warm-up request got HTTP {status}")
        self._concurrent([k % len(self.bodies) for k in range(int(t["max_batch"]))])

    def _read_stdout(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def _make_payloads(self) -> None:
        t = self.traffic
        n = int(t["payloads"])
        gen = torch.Generator().manual_seed(int(np.random.default_rng([self.seed, 1]).integers(2 ** 62)))
        ids = torch.randint(0, 10, (n,), generator=gen)
        images, masks = core.jittered_faces(gen, ids, "cpu", int(t["jitter_levels"]), self.size)
        lights = core.seeded_lights(gen, n, "cpu", float(t["light_z_min"]))
        self.images, self.masks, self.lights = images.numpy(), masks.numpy(), lights.numpy()
        self.bodies = [json.dumps({"image": base64.b64encode(png.encode(self.images[k])).decode(),
                                   "mask": base64.b64encode(png.encode(self.masks[k])).decode(),
                                   "light": [float(v) for v in self.lights[k]]}).encode() for k in range(n)]

    def _post(self, k: int, path: str = "/relight"):
        conn = http.client.HTTPConnection(self.host, self.port, timeout=120)
        try:
            conn.request("POST", path, body=self.bodies[k], headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _get(self, path: str) -> dict:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=60)
        try:
            conn.request("GET", path)
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    def _concurrent(self, ks) -> None:
        threads = [threading.Thread(target=self._post, args=(k,)) for k in ks]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    # -- the window -----------------------------------------------------------
    def schedule(self, rate: float, seconds: float, rng: np.random.Generator):
        """(due seconds from the window's start, payload index) of each request."""
        n = max(1, int(round(rate * seconds)))
        gaps = rng.exponential(1.0, n)
        due = seconds * (np.cumsum(gaps) - gaps[0]) / gaps.sum()
        return due, rng.integers(0, len(self.bodies), n)

    def open_loop(self, rate: float, seconds: float, keep=(), rng=None) -> dict:
        """Offer `rate` requests a second for `seconds`; every request's latency (inf when
        it failed), how late each was sent, and the replies of the requests in `keep`."""
        rng = rng if rng is not None else np.random.default_rng([self.seed, 3])
        due, which = self.schedule(rate, seconds, rng)
        n = len(due)
        lat, late, status = np.full(n, np.inf), np.zeros(n), np.zeros(n, np.int32)
        kept = {}
        work: queue.Queue = queue.Queue()
        keep = set(int(i) for i in keep)

        def worker():
            while True:
                item = work.get()
                if item is None:
                    return
                i, t_due = item
                late[i] = time.perf_counter() - t_due
                try:
                    code, body = self._post(int(which[i]))
                except (OSError, http.client.HTTPException):
                    code, body = 0, b""
                status[i] = code
                if code == 200:
                    lat[i] = time.perf_counter() - t_due
                    if i in keep:
                        kept[i] = body

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(int(self.traffic["workers"]))]
        for th in threads:
            th.start()
        t0 = time.perf_counter() + 0.05
        for i in range(n):
            t_due = t0 + due[i]
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            work.put((i, t_due))
        for _ in threads:
            work.put(None)
        for th in threads:
            th.join(timeout=seconds + 120)
        return {"latency": lat, "late": late, "status": status, "kept": kept, "which": which, "due": due,
                "closed": time.perf_counter() - t0}

    def window(self, seconds: float) -> dict:
        rate = float(self.traffic["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        rng = np.random.default_rng([self.seed, 3])
        self.keep = sorted(np.random.default_rng([self.seed, 4]).choice(n, min(n, int(self.traffic["checked_requests"])),
                                                                         replace=False).tolist())
        profiling = self.traced and self.device.type == "cuda"
        if profiling:  # the server profiles from TRACE_SECONDS before the close
            timer = threading.Timer(max(0.0, seconds - TRACE_SECONDS), self.proc.send_signal, (signal.SIGUSR1,))
            timer.start()
        before = self._get("/statz")
        run = self.open_loop(rate, seconds, self.keep, rng)
        after = self._get("/statz")
        if profiling:
            timer.join()
            self.proc.send_signal(signal.SIGUSR2)
        self.run = run
        lat = run["latency"]
        failed = int(np.sum(~np.isfinite(lat)))
        p95 = core.percentile(np.where(np.isfinite(lat), lat, 1e9), 95) * 1e3
        late = run["late"]
        print(f"generator lateness: median {np.median(late) * 1e3:.3f} ms, p99 {np.percentile(late, 99) * 1e3:.3f} ms, "
              f"max {late.max() * 1e3:.3f} ms over {len(late)} requests", file=sys.stderr)
        d = {k: after[k] - before[k] for k in ("batches", "batched_rows", "padded_rows", "device_seconds")}
        done = run["due"] + lat
        return {"metrics": {"serve_p95_ms": p95, "serve_req_per_s": float(np.sum(done <= seconds)) / seconds},
                "attempted": len(lat), "failed": failed, "statz": d, "seconds": seconds}

    def memory_peak(self) -> int:
        self._stop()
        with open(self.record) as f:
            self.server = json.load(f)
        if self.server["forbidden"]:
            raise RuntimeError(f"the server process loaded {self.server['forbidden']}: "
                               "the benchmark measures the PyTorch port alone")
        return self.server["memory_peak_bytes"]

    def device_info(self) -> dict:
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu", "kind": self.server["kind"], "count": 1}

    def trace(self, window: dict):
        """The server's own device trace, from TRACE_SECONDS before the window's close until
        the window's last reply (its file)."""
        path = self.record + ".trace"
        if not os.path.exists(path):
            return None
        with open(path) as f:
            t = json.load(f)
        return ServerTrace(t)

    def _stop(self) -> None:
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.proc = None

    # -- the check ------------------------------------------------------------
    def free(self) -> None:
        self._stop()

    def answers(self, tf32: bool = False):
        """The reference's uint8 (rendered, shadow) of the kept requests, (N, H, W, 4), and faces."""
        dev = torch.device("cuda" if self.device.type == "cuda" else "cpu")
        net = ref_model.RelightNet(self.variant).to(dev).eval()
        net.load_state_dict(self.state)
        ks = [int(self.run["which"][i]) for i in self.keep]
        out = []
        with torch.no_grad(), precision(tf32):
            for s in range(0, len(ks), 16):
                idx = ks[s:s + 16]
                img = torch.as_tensor(self.images[idx]).to(dev).float() / 255.0
                mask = torch.as_tensor(self.masks[idx]).to(dev).float() / 255.0
                albedo, depth, lighting = net(img)
                r = ref_render.render(albedo, depth, lighting, mask, self.rcfg,
                                      target_light=torch.as_tensor(self.lights[idx]).to(dev))
                pair = torch.cat([r["rendered"] * mask[..., None], (r["shadow"] * mask)[..., None]], dim=-1)
                out.append(ref_render.to_u8(pair).cpu().numpy())
        return np.concatenate(out), self.masks[ks] != 0

    def _replies(self):
        """The kept requests' decoded replies (N, H, W, 4); a request that failed reads as zeros."""
        got = np.zeros((len(self.keep), self.size, self.size, 4), np.uint8)
        for j, i in enumerate(self.keep):
            body = self.run["kept"].get(i)
            if body is None:
                got[j] = 0
                continue
            reply = json.loads(body)
            got[j, ..., :3] = png.decode(base64.b64decode(reply["rendered"]))
            got[j, ..., 3] = png.decode(base64.b64decode(reply["shadow_mask"]))
        return got

    def check(self) -> core.Verdict:
        want, face = self.answers(False)
        self.gaps = core.u8_gaps(self._replies(), want, face)
        shutil.rmtree(self.dir, ignore_errors=True)
        verdict = core.Verdict()
        for name, limit in self.wl["check"].items():
            verdict.add(name, self.gaps[name], limit)
        return verdict

    def control(self) -> dict:
        want, face = self.answers(False)
        return core.u8_gaps(self.answers(True)[0], want, face)

    def faults(self) -> dict:
        """An answer altered where it is produced: one kept reply, every byte moved by 64 levels."""
        want, face = self.answers(False)
        got = self._replies()
        got[0] ^= 64
        return {"answer_altered": core.u8_gaps(got, want, face)}


class ServerTrace:
    """The server process's stretch as its launcher wrote it (busy, length, top operations)."""

    def __init__(self, t: dict):
        self.busy_s, self.window_s, self.ops = t["busy_s"], t["window_s"], t["device_ops"]

    def device_ops(self):
        return self.ops

    def idle_gaps(self):
        return []

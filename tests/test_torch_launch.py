"""The multi-rank launch of the port's CLI and server: two gloo ranks on the CPU under torchrun.

Each test starts `python -m torch.distributed.run --standalone
--nproc-per-node 2` (a rendezvous on localhost) on the small config (32x32
images, 16 samples) and holds what rank 0 writes against one process, byte
for byte:
  * `relight --sample-parallel` (strict, draft): the PNGs of one process;
  * `eval-multipie --data-parallel` at batch 2: the dump and the printed
    metrics of one process at batch 1, each rank's batch;
  * `train`: the epochs' losses equal the in-process data-parallel Trainer's
    (two ranks spawned here, Trainer(mesh=the world)), and only rank 0 prints
    and writes;
  * the server with --data-parallel, --grid-parallel 1x2 and
    --sample-parallel: every answer equals forward_visuals of its tier in one
    process at the rank's batch (a lone request: one row a rank in data mode,
    the whole padded batch of 1 replicated in grid and samples mode), a request that names another tier runs on that
    tier's Relighter over the same mesh (make_tier_pool), and on SIGTERM rank
    0 drains, the follower stops, and both ranks exit 0
    (tests/torch_launch_child.py records each rank's exit code).
"""

import base64
import http.client
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_child as child
from geomconsistentfr_torch import cli as tcli
from geomconsistentfr_torch.config import apply_precision_tier, load_config
from geomconsistentfr_torch.infer import load_relighter
from geomconsistentfr_torch.lighting_presets import LIGHT_PRESETS
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.parallel import distributed
from geomconsistentfr_torch.utils.io import decode_image, imread, write_image_u8
from test_torch_eval import make_dataset
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"render": {"img_height": 32, "img_width": 32, "num_sample_points": 16, "t_start": 0.025, "t_stop": 0.105}}
TRAIN = dict(SMALL, train={"batch_size": 2, "batches_per_epoch": 2, "log_every_steps": 1,
                           "checkpoint_every_steps": 0})
ENV = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
TIMEOUT = 240


def torchrun(*args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", *map(str, args)]


def run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, env=ENV, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Transfer-variant weights (.pth), a 32x32 face and an ellipse mask, the small config."""
    from geomconsistentfr_torch.config import preset_lighting_transfer

    root = tmp_path_factory.mktemp("launch")
    torch.save(RelightNet(preset_lighting_transfer().model, generator=torch.Generator().manual_seed(5)).state_dict(),
               root / "w.pth")
    rng = np.random.default_rng(0)
    write_image_u8(str(root / "face.png"), rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
    yy, xx = np.mgrid[:32, :32]
    mask = ((((xx - 16) / 10.0) ** 2 + ((yy - 17) / 13.0) ** 2) <= 1.0).astype(np.uint8) * 255
    write_image_u8(str(root / "mask.png"), mask)
    (root / "small.json").write_text(json.dumps(SMALL))
    (root / "train.json").write_text(json.dumps(TRAIN))
    return {k: str(root / v) for k, v in dict(pth="w.pth", image="face.png", mask="mask.png",
                                              config="small.json", train="train.json").items()}


def dir_bytes(path: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("tier", ["strict", "draft"])
def test_relight_sample_parallel_equals_one_process(files, tmp_path, tier, capsys):
    args = ["relight", "--checkpoint", files["pth"], "--config", files["config"], "--precision", tier,
            "--device", "cpu", "--image", files["image"], "--mask", files["mask"], "--light-preset", "multipie_14"]
    assert tcli.main(args + ["--out", str(tmp_path / "one")]) == 0
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    proc = run(torchrun("-m", "geomconsistentfr_torch.cli", *args, "--sample-parallel", "--out", tmp_path / "two"),
               tmp_path)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1  # rank 0 prints, rank 1 does not
    got = json.loads(lines[0])
    assert got["composited"] == want["composited"]
    one, two = dir_bytes(tmp_path / "one"), dir_bytes(tmp_path / "two")
    assert sorted(two) == sorted(one) and len(one) == 7
    for name in one:
        assert two[name] == one[name], name


def test_eval_multipie_data_parallel_equals_one_process(files, tmp_path, capsys):
    root = make_dataset(tmp_path / "mp", n=5, size=32)
    args = ["eval-multipie", "--checkpoint", files["pth"], "--config", files["config"], "--device", "cpu",
            "--data-root", root]
    # Each rank runs one row of a batch of 2: one process at batch 1 runs
    # the same convolutions (at batch 2 their rounding may differ).
    assert tcli.main(args + ["--batch-size", "1", "--out", str(tmp_path / "one")]) == 0
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    proc = run(torchrun("-m", "geomconsistentfr_torch.cli", *args, "--batch-size", "2", "--data-parallel",
                        "--out", tmp_path / "two"), tmp_path)
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert lines == [want] and want["num_inferred"] == 5
    one, two = dir_bytes(tmp_path / "one"), dir_bytes(tmp_path / "two")
    assert sorted(two) == sorted(one) and len(one) == 5 * 6
    for name in one:
        assert two[name] == one[name], name


def test_train_steps_with_the_data_parallel_trainer(files, tmp_path):
    cfg = load_config(files["train"], preset="target_lighting_train")
    ctx = distributed.spawn(child.trainer_epochs, 2, "cpu", str(tmp_path / "rdzv"), join=False,
                            args=(str(tmp_path), "trainer", cfg, str(tmp_path / "spawned"), 2, 8))
    proc = run(torchrun("-m", "geomconsistentfr_torch.cli", "train", "--config", files["train"], "--device", "cpu",
                        "--data", "synthetic", "--synthetic-samples", "8", "--epochs", "2", "--out", tmp_path / "run"),
               tmp_path)
    while not ctx.join():
        pass
    want = torch.load(tmp_path / "trainer_rank0.pt", weights_only=False)["epochs"]
    got = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert [m["epoch"] for m in got] == [0, 1]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k != "seconds":
                assert g[k] == v, (g["epoch"], k)
    # Rank 0 alone wrote the checkpoints.
    assert sorted(os.listdir(tmp_path / "run" / cfg.train.checkpoint_dir)) == ["step_00000002", "step_00000004"]


def b64(path) -> str:
    return base64.b64encode(Path(path).read_bytes()).decode()


def post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize("mode", [["--data-parallel"], ["--grid-parallel", "1x2"], ["--sample-parallel"]],
                         ids=["data", "grid", "samples"])
def test_server_answers_as_one_process_and_drains_on_sigterm(files, tmp_path, mode):
    ranks = tmp_path / "ranks"
    ranks.mkdir()
    cmd = torchrun(ROOT / "tests" / "torch_launch_child.py", ranks, "geomconsistentfr_torch.serve",
                   "--checkpoint", files["pth"], "--config", files["config"], "--device", "cpu", "--port", "0",
                   "--max-batch", "4", *mode)
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while True:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-4000:]
            if line.startswith('{"serving"'):
                break
        serving = json.loads(line)
        parallel = {"--data-parallel": "data", "--grid-parallel": "grid", "--sample-parallel": "samples"}[mode[0]]
        assert serving["ranks"] == 2 and serving["parallel"] == parallel
        port = int(serving["serving"].rsplit(":", 1)[1])
        image, mask = imread(files["image"]), imread(files["mask"])
        requests = [("high", {"light_preset": "multipie_14"}), ("high", {"light": [0.3, -0.2, 0.9]}),
                    ("draft", {"light_preset": "multipie_14", "precision": "draft"})]
        answers = []
        for _, extra in requests:
            status, reply = post(port, "/relight", {"image": b64(files["image"]), "mask": b64(files["mask"]),
                                                    "ambient": 0.5, **extra})
            assert status == 200, reply
            answers.append(reply)
        status, est = post(port, "/estimate", {"image": b64(files["image"])})
        assert status == 200
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = [json.loads(x) for x in (line + out).splitlines() if x.startswith("{")]
    last = next(x for x in lines if "drained" in x)
    follower = next(x for x in lines if "follower" in x)
    assert last["drained"] is True and last["stats"]["relight_requests"] == 3, err[-4000:]
    # Every tier, the one a request named too, runs over the two ranks.
    assert last["tiers"] == follower["tiers"] == {t: {"ranks": 2, "parallel": parallel} for t in ("draft", "high")}
    assert follower["calls"] == {"forward_visuals": 3, "estimate_lighting": 1}
    for r in (0, 1):
        assert json.loads((ranks / f"rank{r}.json").read_text()) == {"exit_code": 0}, r
    # One process at the rank's batch: one row in data mode (the batch of 2
    # is the request and its padding), the batch of 1 in grid mode.
    one = {tier: load_relighter(files["pth"], device="cpu", cfg=apply_precision_tier(
        load_config(files["config"], preset="single_image"), tier)) for tier in ("high", "draft")}
    for (tier, extra), reply in zip(requests, answers):
        light = np.asarray([LIGHT_PRESETS[extra["light_preset"]] if "light_preset" in extra else extra["light"]],
                           np.float32)
        pack = one[tier].forward_visuals(image[None], mask[None], target_light=light,
                                         target_ambient=np.asarray([0.5], np.float32))[0].numpy()
        assert np.array_equal(decode_image(base64.b64decode(reply["rendered"])), pack[..., 0:3]), tier
        assert np.array_equal(decode_image(base64.b64decode(reply["shadow_mask"])), pack[..., 3]), tier
    unit, ambient = one["high"].estimate_lighting(image[None])
    assert est["direction"] == [float(v) for v in unit[0]] and est["ambient"] == float(ambient[0])


def test_tier_pool_keeps_the_mesh(files):
    """make_tier_pool builds each tier over the default relighter's mesh and mode."""
    from geomconsistentfr_torch import serve as tserve
    from geomconsistentfr_torch.parallel.mesh import make_mesh

    cfg = apply_precision_tier(load_config(files["config"], preset="single_image"), "high")
    rl = load_relighter(files["pth"], cfg=cfg, mesh=make_mesh("cpu"), parallel="samples")
    pool = tserve.make_tier_pool(cfg, rl, "high")
    assert pool("high") is rl
    draft = pool("draft")
    assert draft.mesh is rl.mesh and draft.parallel == "samples" and draft.cfg.render.shadow_resolution_scale > 1
    assert tserve.tier_meshes(pool) == {t: {"ranks": 1, "parallel": "samples"} for t in ("draft", "high")}

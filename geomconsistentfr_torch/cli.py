"""Command-line interface of the PyTorch/CUDA port.

    python -m geomconsistentfr_torch.cli <command> ...

Port of geomconsistentfr_tpu/cli.py. Commands:

  relight        test_relight_single_image.py (a target light, one image)
  sweep          one image under every lighting preset
  transfer       test_relight_single_image_lighting_transfer.py (two passes)
  eval-multipie  the 862-image protocol: the inference dump, then masked
                 MSE, MATLAB-parity DSSIM, PSNR and (--lpips-*) LPIPS
  train          train_raytracing_relighting_CelebAHQ_DSSIM_8x.py /
                 train_lighting_transfer.py (one JSON line an epoch)
  build-cache    pack the reference MP_data layout into the training cache
  crop           recrop_CelebA-HQ_images.py's face crop (S3FD, a box or a mask)
  fix-border     fix_border_artifacts_CVPR2022.m
  config         print a preset (and --config overrides) as JSON
  lpips-train    train LPIPS's linear heads on a BAPPS-style 2AFC directory
  lpips-score    2AFC or JND score of LPIPS, L2 or DSSIM on a BAPPS directory
  visualize-lighting  shaded spheres, one PNG per light direction
  convert        a reference .pth -> an orbax checkpoint of flax variables
  bench          the port's throughput bench (geomconsistentfr_torch.bench)

The model commands run on CUDA unless given `--device cpu`, and raise without
a card. `--checkpoint` takes a reference .pth or an orbax checkpoint
directory (utils/orbax.py reads it; no orbax or JAX is needed).

Several ranks, one process each, under torchrun (JAX's rules,
geomconsistentfr_tpu/cli.py:90-104):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m geomconsistentfr_torch.cli relight --sample-parallel ...

`--sample-parallel` (relight, sweep, transfer, eval-multipie) shards the
shadow march's t grid over the ranks; `--data-parallel` (eval-multipie; the
batch a multiple of the world) shards the batch. The two conflict. Either
joins the process group (`distributed.initialize`; in one process it does
nothing, as JAX's mesh over one device does) and builds the world mesh.
`train` under torchrun steps data-parallel over the world (the batch a
multiple of it). Every rank reads the same inputs; only rank 0 writes files
and prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from geomconsistentfr_torch.config import PRECISION_TIERS

LPIPS_NETS = ("alex", "vgg", "squeeze")


def _add_common_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint", required=True, help="reference .pth state dict or orbax checkpoint directory")
    p.add_argument("--preset", default=None, help="pipeline preset (default: per command)")
    p.add_argument("--config", default=None, help="JSON file with (partial) PipelineConfig overrides on the preset")
    p.add_argument("--out", default="outputs", help="output directory")
    p.add_argument(
        "--precision", choices=PRECISION_TIERS, default=None,
        help="serving precision tier: 'strict' and 'high' = float32 CNN and the one-hot veto (on the card "
        "the two are the same); 'fast' = bfloat16 CNN activations and the bilinear veto; 'draft' = fast "
        "plus a quarter-resolution march with a full-resolution refine (preview grade). Default: high "
        "(none when --config is given, so the file's precision fields are honoured).",
    )
    p.add_argument("--fast", action="store_true", help="alias for --precision fast")
    p.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain paths)")
    p.add_argument("--sample-parallel", action="store_true",
                   help="latency parallelism under torchrun: shard the shadow march's sample grid over the ranks "
                   "(an exact MIN combine; outputs identical to one process). Any batch size works")


def _world(args):
    """Join torchrun's process group (the ranks on the CPU for --device cpu, else
    on the cards); the world mesh, or None in a single process."""
    from geomconsistentfr_torch.parallel import distributed
    from geomconsistentfr_torch.parallel.mesh import make_mesh

    device = distributed.initialize("cpu" if args.device == "cpu" else "cuda")
    return None if device is None else make_mesh(device)


def _relighter(args, default_preset: str):
    from geomconsistentfr_torch.config import PRESETS, apply_precision_tier, load_config
    from geomconsistentfr_torch.infer import load_relighter, resolve_device

    data_parallel = getattr(args, "data_parallel", False)
    sample_parallel = getattr(args, "sample_parallel", False)
    if data_parallel and sample_parallel:
        raise SystemExit("--data-parallel conflicts with --sample-parallel")
    mesh = None
    if data_parallel or sample_parallel:
        from geomconsistentfr_torch.parallel.mesh import make_mesh

        # One process: a mesh of one rank, as JAX's make_mesh over one device.
        mesh = _world(args) or make_mesh(resolve_device(args.device))
    device = mesh.device if mesh is not None else resolve_device(args.device)
    preset = args.preset or default_preset
    cfg = load_config(args.config, preset=preset) if args.config else PRESETS[preset]()
    tier = args.precision
    if args.fast:
        if tier and tier != "fast":
            raise SystemExit("--fast conflicts with --precision " + tier)
        tier = "fast"
    if tier is None and not args.config:
        tier = "high"  # the default serving tier; a --config file keeps its own precision fields
    if tier:
        cfg = apply_precision_tier(cfg, tier)
    return load_relighter(args.checkpoint, cfg=cfg, device=device, mesh=mesh,
                          parallel="samples" if sample_parallel else "data")


def _writer() -> bool:
    from geomconsistentfr_torch.parallel.distributed import is_writer

    return is_writer()


def _parse_light(args):
    import numpy as np

    from geomconsistentfr_torch.lighting_presets import DEFAULT_AMBIENT, LIGHT_PRESETS

    if args.light_preset:
        direction = LIGHT_PRESETS[args.light_preset]
    else:
        if not args.light:
            raise SystemExit("relight needs --light lx,ly,lz or --light-preset NAME")
        direction = tuple(float(v) for v in args.light.split(","))
        if len(direction) != 3:
            raise SystemExit("--light expects lx,ly,lz")
    ambient = args.ambient if args.ambient is not None else DEFAULT_AMBIENT
    return np.asarray([direction], np.float32), np.asarray([ambient], np.float32)


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def cmd_relight(args) -> int:
    import numpy as np

    from geomconsistentfr_torch.utils.io import read_image, read_mask, save_visual_pack, write_image

    rl = _relighter(args, "single_image")
    size = rl.cfg.render.img_height
    img = read_image(args.image, size)
    mask = read_mask(args.mask, size)
    light, ambient = _parse_light(args)
    pack = rl.forward_visuals(img[None], mask[None], target_light=light, target_ambient=ambient)[0].cpu().numpy()
    if not _writer():
        return 0
    stem = _stem(args.image)
    paths = save_visual_pack(args.out, stem, pack)
    # pack[..., 0:3] is rendered * mask quantized on the device; the composite
    # pastes it into the original where the mask is nonzero (reference :618-619).
    mask3 = np.repeat(mask[..., None], 3, axis=-1)
    composited = np.where(mask3 > 0, pack[..., 0:3] / 255.0, img)
    if args.fix_border:
        from geomconsistentfr_torch.postprocess import fix_border_artifacts

        composited = fix_border_artifacts(composited, mask)
    write_image(os.path.join(args.out, f"{stem}_composited.png"), composited)
    print(json.dumps({"outputs": paths, "composited": f"{stem}_composited.png"}))
    return 0


def cmd_sweep(args) -> int:
    import numpy as np

    from geomconsistentfr_torch.lighting_presets import DEFAULT_AMBIENT, LIGHT_PRESETS
    from geomconsistentfr_torch.utils.io import read_image, read_mask, write_image_u8

    rl = _relighter(args, "single_image")
    size = rl.cfg.render.img_height
    img = read_image(args.image, size)
    mask = read_mask(args.mask, size)
    names = list(LIGHT_PRESETS)
    lights = np.asarray([LIGHT_PRESETS[n] for n in names], np.float32)
    ambients = np.full((len(names),), DEFAULT_AMBIENT, np.float32)
    tiles = rl.relight_sweep_rendered_u8(img, mask, lights, ambients).cpu().numpy()
    if not _writer():
        return 0
    stem = _stem(args.image)
    for i, name in enumerate(names):
        write_image_u8(os.path.join(args.out, f"{stem}_{name}.png"), tiles[i])
    cols = 4  # a contact sheet of the whole sweep
    rows = -(-len(tiles) // cols)
    h, w = tiles.shape[1:3]
    sheet = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(len(names)):
        r, c = divmod(i, cols)
        sheet[r * h : (r + 1) * h, c * w : (c + 1) * w] = tiles[i]
    write_image_u8(os.path.join(args.out, f"{stem}_sweep_montage.png"), sheet)
    print(json.dumps({"num_lights": len(names), "out": args.out, "montage": f"{stem}_sweep_montage.png"}))
    return 0


def cmd_transfer(args) -> int:
    from geomconsistentfr_torch.utils.io import read_image, read_mask, save_visual_pack

    rl = _relighter(args, "lighting_transfer")
    size = rl.cfg.render.img_height
    img = read_image(args.input, size)
    ref = read_image(args.reference, size)
    mask = read_mask(args.mask, size)
    # Two passes: the light estimated from the reference, then one packed
    # uint8 fetch of the six outputs.
    unit, ambient = rl.estimate_lighting(ref[None])
    pack = rl.forward_visuals(img[None], mask[None], target_light=unit, target_ambient=ambient)[0].cpu().numpy()
    if not _writer():
        return 0
    paths = save_visual_pack(args.out, _stem(args.input), pack)
    print(json.dumps({
        "outputs": paths,
        "estimated_direction": [float(v) for v in unit[0].cpu()],
        "estimated_ambient": float(ambient[0]),
    }))
    return 0


def _lpips_metric(args):
    """The LPIPS map function of eval-multipie's --lpips-* flags, or None."""
    from geomconsistentfr_torch.infer import resolve_device
    from geomconsistentfr_torch.models.lpips import LPIPSMetric, load_trunk_state

    if not (args.lpips_trunk or args.lpips_random_trunk):
        print("note: LPIPS skipped: no trunk weights supplied (pass --lpips-trunk <torchvision .pth/.npz> and "
              "--lpips-lin); reporting masked MSE/DSSIM/PSNR only", file=sys.stderr)
        return None
    trunk = load_trunk_state(args.lpips_trunk, net=args.lpips_net) if args.lpips_trunk else None
    return LPIPSMetric(lin_weights_path=args.lpips_lin, trunk_state=trunk, allow_random_trunk=args.lpips_random_trunk,
                       net=args.lpips_net, device=resolve_device(args.device))


def cmd_eval_multipie(args) -> int:
    from geomconsistentfr_torch.metrics.eval_multipie import evaluate_output_dir, run_inference

    root = args.data_root
    gt_dir = os.path.join(root, "groundtruth_images_MP_18_lightings")
    mask_dir = os.path.join(root, "MP_depth_masks_fill_nose")
    # --eval-only re-scores an existing dump without the relighter.
    rl = None if args.eval_only else _relighter(args, "multipie_eval")
    lpips_fn = _lpips_metric(args) if _writer() else None  # rank 0 scores
    n = 0
    if rl is not None:
        n = run_inference(
            rl,
            input_dir=os.path.join(root, "input_images_MP_18_lightings"),
            gt_dir=gt_dir,
            lighting_mat=os.path.join(root, "MP_lighting_directions.mat"),
            mask_fill_nose_dir=mask_dir,
            output_dir=args.out,
            limit=args.limit,
            batch_size=args.batch_size,
        )
    if not _writer():
        return 0
    metrics = evaluate_output_dir(args.out, gt_dir, mask_dir, lpips_fn=lpips_fn)
    metrics["num_inferred"] = n
    print(json.dumps(metrics))
    return 0


def cmd_train(args) -> int:
    """The GAN training loop: one JSON line of mean losses an epoch; resumes from <out>'s checkpoints."""
    from geomconsistentfr_torch.config import PRESETS, apply_precision_tier, load_config
    from geomconsistentfr_torch.infer import resolve_device
    from geomconsistentfr_torch.train import Trainer
    from geomconsistentfr_torch.utils.profiling import debug_nans

    # Under torchrun every rank steps on its slice of each batch (the world
    # mesh, data-parallel; JAX's Trainer defaults to a mesh over every device).
    mesh = _world(args)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    preset = args.preset or "target_lighting_train"
    cfg = load_config(args.config, preset=preset) if args.config else PRESETS[preset]()
    if args.precision:
        cfg = apply_precision_tier(cfg, args.precision)
    if args.data == "synthetic":
        from geomconsistentfr_torch.data import SyntheticFaceData

        data = SyntheticFaceData(num_samples=args.synthetic_samples, size=cfg.render.img_height)
    else:
        from geomconsistentfr_torch.data import CelebAHQRelightingData

        data = CelebAHQRelightingData(args.data)
    trainer = Trainer(cfg, data=data, workdir=args.out, device=device, mesh=mesh, profile=args.profile)
    state = trainer.init_or_resume()
    # The shuffle derives from (seed, epoch), so a resumed run replays the
    # uninterrupted batch order; a mid-epoch step checkpoint resumes inside
    # its epoch, skipping the batches already trained.
    start_epoch, start_batch = divmod(int(state.step), cfg.train.batches_per_epoch)
    debug_nans(args.debug_nans)
    try:
        for epoch in range(start_epoch, args.epochs):
            state, metrics = trainer.run_epoch(state, epoch, start_batch=start_batch)
            start_batch = 0
            trainer.save(state)
            if args.visualize_every and (epoch + 1) % args.visualize_every == 0:
                metrics["visuals"] = trainer.visualize(state, epoch)
            if trainer.writes:
                print(json.dumps(metrics), flush=True)
    finally:
        debug_nans(False)
    return 0


def cmd_convert(args) -> int:
    """A reference .pth -> an orbax checkpoint directory of flax variables (JAX's `cli convert`)."""
    from geomconsistentfr_torch.convert import load_checkpoint, variables_from_state_dict
    from geomconsistentfr_torch.utils.checkpoint import save_variables

    variables = variables_from_state_dict(load_checkpoint(args.pth))
    save_variables(args.out, variables)
    n = sum(leaf.size for tree in variables.values() for module in tree.values() for leaf in module.values())
    print(json.dumps({"out": args.out, "num_values": int(n)}))
    return 0


def cmd_build_cache(args) -> int:
    import time

    from geomconsistentfr_torch.data.celebahq import build_cache, jpeg_reader

    decoder = jpeg_reader()[0]
    t0 = time.perf_counter()
    n = build_cache(args.src, args.out, limit=args.limit)
    seconds = time.perf_counter() - t0
    print(json.dumps({"num_samples": n, "cache": args.out, "decoder": decoder, "seconds": seconds,
                      "samples_per_s": n / seconds if seconds > 0 else None}))
    return 0


def cmd_crop(args) -> int:
    """Face-crop preprocessing (recrop_CelebA-HQ_images.py's geometry) of the largest detected face."""
    import numpy as np

    from geomconsistentfr_torch.preprocess import (
        box_from_mask,
        crop_face,
        crop_largest_face,
        detect_faces_s3fd,
        detect_faces_sfd,
    )
    from geomconsistentfr_torch.utils.io import imread, write_image_u8

    img = np.asarray(imread(args.image))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = np.ascontiguousarray(img[..., :3])
    detections = None
    if args.box:
        box = tuple(float(v) for v in args.box.split(","))
        if len(box) != 4:
            raise SystemExit("--box expects x1,y1,x2,y2")
        crop = crop_face(img, box)
    elif args.mask:
        crop = crop_face(img, box_from_mask(np.asarray(imread(args.mask))))
    else:
        if args.s3fd_weights:
            detections = detect_faces_s3fd(img, weights_path=args.s3fd_weights, device=args.device)
        else:
            detections = detect_faces_sfd(img)
        if not len(detections):
            print(json.dumps({"error": "no face detected"}))
            return 1
        crop = crop_largest_face(img, [tuple(float(v) for v in d[:4]) for d in detections])
    if crop is None:
        print(json.dumps({"error": "face below 200px minimum"}))
        return 1
    write_image_u8(args.out_image, np.asarray(crop, np.uint8))
    report = {"out": args.out_image}
    if detections is not None:
        report["detections"] = len(detections)
    print(json.dumps(report))
    return 0


def cmd_fix_border(args) -> int:
    import numpy as np

    from geomconsistentfr_torch.postprocess import fix_border_artifacts
    from geomconsistentfr_torch.utils.io import imread, read_mask, write_image_u8

    img = np.asarray(imread(args.image))
    mask = read_mask(args.mask, size=img.shape[0])
    out = args.out_image or args.image
    write_image_u8(out, fix_border_artifacts(img, mask).astype(np.uint8))
    print(json.dumps({"out": out}))
    return 0


def cmd_config(args) -> int:
    """Print the resolved pipeline config as JSON (reusable as a --config file)."""
    from geomconsistentfr_torch.config import PRESETS, load_config, to_dict

    cfg = load_config(args.config, preset=args.preset) if args.config else PRESETS[args.preset]()
    print(json.dumps(to_dict(cfg), indent=2, default=str))
    return 0


def cmd_lpips_train(args) -> int:
    """Train LPIPS's heads and ranking net on a BAPPS-style 2AFC directory (the library's
    trainer.py and scripts/train_test_metric.sh: --epochs at a constant rate, then
    --epochs-decay of linear decay); one JSON line an epoch, the heads to --out."""
    import numpy as np

    from geomconsistentfr_torch.data.bapps import TwoAFCDirectory
    from geomconsistentfr_torch.infer import resolve_device
    from geomconsistentfr_torch.metrics.lpips_train import LPIPS2AFCTrainer
    from geomconsistentfr_torch.models.lpips import load_trunk_state

    trunk = load_trunk_state(args.trunk, net=args.net) if args.trunk else None
    trainer = LPIPS2AFCTrainer(trunk_state=trunk, allow_random_trunk=args.random_trunk, lr=args.lr, net=args.net,
                               seed=args.seed, device=resolve_device(args.device))
    data = TwoAFCDirectory(args.data_root, load_size=args.load_size)
    if not len(data):
        raise SystemExit(f"no 2AFC triples under {args.data_root}")
    for epoch in range(args.epochs + args.epochs_decay):
        agg = [trainer.train_step(batch) for batch in data.batches(
            args.batch_size, shuffle=True, seed=args.seed + epoch, drop_remainder=len(data) > args.batch_size)]
        row = {"epoch": epoch, "batches": len(agg), **{k: float(np.mean([m[k] for m in agg])) for k in agg[0]}}
        if epoch >= args.epochs:
            row["lr"] = trainer.decay_learning_rate(args.epochs_decay)
        print(json.dumps(row), flush=True)
    trainer.save_lin_weights(args.out)
    print(json.dumps({"lin_weights": args.out, "net": args.net}))
    return 0


def cmd_lpips_score(args) -> int:
    """2AFC agreement or JND score of LPIPS, L2 or DSSIM on a BAPPS-style directory
    (the library's test_dataset_model.py)."""
    import numpy as np

    from geomconsistentfr_torch.data.bapps import score_2afc_directory, score_jnd_directory
    from geomconsistentfr_torch.metrics.perceptual import dssim_distance, l2_distance

    if args.metric == "l2":
        distance = l2_distance
    elif args.metric == "dssim":
        distance = dssim_distance
    else:
        from geomconsistentfr_torch.infer import resolve_device
        from geomconsistentfr_torch.models.lpips import LPIPSMetric, load_trunk_state

        trunk = load_trunk_state(args.trunk, net=args.net) if args.trunk else None
        metric = LPIPSMetric(lin_weights_path=args.lin, trunk_state=trunk, allow_random_trunk=args.random_trunk,
                             net=args.net, device=resolve_device(args.device))

        def distance(a, b):
            return float(np.mean(metric(a, b)))

    if args.mode == "2afc":
        score = score_2afc_directory(args.data_root, distance, load_size=args.load_size)
    else:
        if len(args.data_root) != 1:
            raise SystemExit(f"--mode jnd takes one --data-root (with p0/ p1/ same/), got {len(args.data_root)}")
        score = score_jnd_directory(args.data_root[0], distance, load_size=args.load_size)
    print(json.dumps({"mode": args.mode, "metric": args.metric, "score": round(score, 6)}))
    return 0


def cmd_visualize_lighting(args) -> int:
    """Shaded spheres, one PNG per light direction (the reference's lighting_visualizations/)."""
    import numpy as np

    from geomconsistentfr_torch.lighting_presets import LIGHT_PRESETS, azimuth_elevation, lighting_sphere
    from geomconsistentfr_torch.utils.io import write_image_u8

    if args.light:
        vals = [float(v) for v in args.light.split(",")]
        if len(vals) != 3:
            raise SystemExit("--light expects lx,ly,lz")
        targets = {"custom": tuple(vals)}
    elif args.azimuth is not None or args.elevation is not None:
        az, el = args.azimuth or 0.0, args.elevation or 0.0
        targets = {f"A{az:g}E{el:g}": azimuth_elevation(az, el)}
    elif args.preset:
        targets = {args.preset: LIGHT_PRESETS[args.preset]}
    else:
        targets = dict(LIGHT_PRESETS)
    os.makedirs(args.out, exist_ok=True)
    for name, direction in targets.items():
        sphere = lighting_sphere(direction, size=args.size, ambient=args.ambient, directional=args.directional,
                                 clamp=args.clamp)
        write_image_u8(os.path.join(args.out, f"{name}.png"), (sphere * 255.0 + 0.5).astype(np.uint8))
    print(json.dumps({"out": args.out, "count": len(targets)}))
    return 0


def cmd_bench(args) -> int:
    from geomconsistentfr_torch import bench

    return bench.main()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="geomconsistentfr_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("relight", help="relight one image with a target light")
    _add_common_model_args(p)
    p.add_argument("--image", required=True)
    p.add_argument("--mask", required=True)
    p.add_argument("--light", default=None, help="lx,ly,lz")
    p.add_argument("--light-preset", default=None)
    p.add_argument("--ambient", type=float, default=None)
    p.add_argument("--fix-border", action="store_true")
    p.set_defaults(fn=cmd_relight)

    p = sub.add_parser("sweep", help="relight one image under all presets")
    _add_common_model_args(p)
    p.add_argument("--image", required=True)
    p.add_argument("--mask", required=True)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("transfer", help="two-pass lighting transfer")
    _add_common_model_args(p)
    p.add_argument("input")
    p.add_argument("reference")
    p.add_argument("mask")
    p.set_defaults(fn=cmd_transfer)

    p = sub.add_parser("eval-multipie", help="the 862-image evaluation protocol")
    _add_common_model_args(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--data-parallel", action="store_true",
                   help="under torchrun, shard inference batches over the ranks (--batch-size a multiple of the "
                   "world size)")
    p.add_argument("--eval-only", action="store_true",
                   help="skip inference: re-score the existing dump in --out (the checkpoint is not loaded)")
    p.add_argument("--lpips-trunk", default=None,
                   help="trunk weights (torchvision state_dict .pth/.pt or .npz) for --lpips-net: adds the masked "
                   "spatial LPIPS (test_network.py:30-52)")
    p.add_argument("--lpips-net", default="alex", choices=LPIPS_NETS, help="LPIPS trunk (lpips/lpips.py:32-40)")
    p.add_argument("--lpips-lin", default=None,
                   help="LPIPS linear heads (the library's weights/v0.1/<net>.pth, or an lpips-train .npz)")
    p.add_argument("--lpips-random-trunk", action="store_true",
                   help="smoke only: a seeded random trunk (and random heads without --lpips-lin); the numbers "
                   "are not the calibrated metric")
    p.set_defaults(fn=cmd_eval_multipie)

    p = sub.add_parser("train", help="self-supervised GAN training")
    p.add_argument("--preset", default=None, help="pipeline preset (default: target_lighting_train)")
    p.add_argument("--config", default=None, help="JSON PipelineConfig overrides")
    p.add_argument("--precision", choices=("strict", "high", "fast"), default=None,
                   help="training precision tier (config.apply_precision_tier without 'draft', which changes the "
                   "marched computation and only serves); applied after --config. Default: the preset's float32")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop at the first NaN: autograd's anomaly mode and a check of every module's output "
                   "(utils/profiling.debug_nans; narrower than JAX's jax_debug_nans)")
    p.add_argument("--profile", action="store_true", help="torch.profiler Chrome traces into <out>/profile")
    p.add_argument("--data", default="synthetic", help="a build-cache directory, or 'synthetic'")
    p.add_argument("--synthetic-samples", type=int, default=64)
    p.add_argument("--visualize-every", type=int, default=0,
                   help="every N epochs, render a fixed probe through the current generator into "
                   "<out>/visuals/index.html (0 = off)")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--out", default="runs/train")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain paths). Under torchrun each rank takes "
                   "its own card (or shares one), or the CPU for 'cpu'")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("convert", help="a reference .pth -> an orbax checkpoint directory")
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("build-cache", help="pack MP_data into the training cache's memmaps")
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.set_defaults(fn=cmd_build_cache)

    p = sub.add_parser("crop", help="face-crop preprocessing (the reference's geometry)")
    p.add_argument("--image", required=True)
    p.add_argument("--box", default=None, help="x1,y1,x2,y2 (else --mask, else a detector)")
    p.add_argument("--mask", default=None, help="a face mask PNG: its bounding box is the face box")
    p.add_argument("--s3fd-weights", default=None,
                   help="face_alignment's s3fd.pth: run the port's S3FD (models/s3fd.py) and crop the largest face "
                   "(else face_alignment's SFD, where it is installed)")
    p.add_argument("--out-image", required=True)
    p.add_argument("--device", default=None, help="torch device for S3FD (default: cuda)")
    p.set_defaults(fn=cmd_crop)

    p = sub.add_parser("fix-border", help="border-artifact median fix")
    p.add_argument("--image", required=True)
    p.add_argument("--mask", required=True)
    p.add_argument("--out-image", default=None)
    p.set_defaults(fn=cmd_fix_border)

    p = sub.add_parser("config", help="print a fully resolved preset config as JSON")
    p.add_argument("--preset", default="single_image", help="preset name (see config.PRESETS)")
    p.add_argument("--config", default=None, help="JSON overrides to resolve")
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("lpips-train", help="train LPIPS's linear heads on a BAPPS-style 2AFC directory")
    p.add_argument("--data-root", required=True, nargs="+", help="2AFC roots (each with ref/ p0/ p1/ judge/)")
    p.add_argument("--out", required=True, help="the trained heads (.npz, or a torch file)")
    p.add_argument("--net", default="alex", choices=LPIPS_NETS)
    p.add_argument("--trunk", default=None, help="trunk weights (.pth/.npz)")
    p.add_argument("--random-trunk", action="store_true", help="smoke only: a seeded random frozen trunk")
    p.add_argument("--epochs", type=int, default=10, help="constant-rate epochs (the reference's nepoch)")
    p.add_argument("--epochs-decay", type=int, default=10, help="linear-decay epochs (nepoch_decay)")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--load-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.set_defaults(fn=cmd_lpips_train)

    p = sub.add_parser("lpips-score", help="2AFC / JND score of LPIPS, L2 or DSSIM on a BAPPS directory")
    p.add_argument("--mode", choices=("2afc", "jnd"), default="2afc")
    p.add_argument("--data-root", required=True, nargs="+",
                   help="roots (2afc: ref/ p0/ p1/ judge/; jnd: one root with p0/ p1/ same/)")
    p.add_argument("--metric", choices=("lpips", "l2", "dssim"), default="lpips")
    p.add_argument("--net", default="alex", choices=LPIPS_NETS)
    p.add_argument("--trunk", default=None, help="LPIPS trunk weights")
    p.add_argument("--lin", default=None, help="LPIPS linear heads")
    p.add_argument("--random-trunk", action="store_true", help="smoke only: a seeded random LPIPS trunk")
    p.add_argument("--load-size", type=int, default=64)
    p.add_argument("--device", default=None, help="torch device for LPIPS (default: cuda)")
    p.set_defaults(fn=cmd_lpips_score)

    p = sub.add_parser("visualize-lighting", help="shaded-sphere lighting visualizations")
    p.add_argument("--out", required=True)
    p.add_argument("--preset", default=None, help="one preset (default: all)")
    p.add_argument("--light", default=None, help="lx,ly,lz explicit direction")
    p.add_argument("--azimuth", type=float, default=None)
    p.add_argument("--elevation", type=float, default=None)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--ambient", type=float, default=0.458)
    p.add_argument("--directional", type=float, default=0.572)
    p.add_argument("--clamp", action="store_true",
                   help="clamp n.l at 0 (the face renderer's shading; the default matches the reference's sphere "
                   "assets, which do not clamp)")
    p.set_defaults(fn=cmd_visualize_lighting)

    p = sub.add_parser("bench", help="throughput benchmark on the card (one JSON line)")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    finally:
        if "torch.distributed" in sys.modules:  # else no command joined a process group
            from geomconsistentfr_torch.parallel import distributed

            distributed.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())

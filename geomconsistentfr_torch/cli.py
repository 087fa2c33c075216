"""Command-line interface of the PyTorch/CUDA port.

    python -m geomconsistentfr_torch.cli <command> ...

Port of geomconsistentfr_tpu/cli.py. Commands:

  relight        test_relight_single_image.py (a target light, one image)
  sweep          one image under every lighting preset
  transfer       test_relight_single_image_lighting_transfer.py (two passes)
  eval-multipie  the 862-image protocol: the inference dump, then masked
                 MSE, MATLAB-parity DSSIM and PSNR
  fix-border     fix_border_artifacts_CVPR2022.m
  config         print a preset (and --config overrides) as JSON
  bench          the port's throughput bench (geomconsistentfr_torch.bench)

The model commands run on CUDA unless given `--device cpu`, and raise without
a card. Not ported yet, each exits non-zero naming its ROADMAP item:
`train` and `build-cache`, `crop`, LPIPS (`eval-multipie --lpips-*`), the
multi-rank launch (`--data-parallel`, `--sample-parallel`); and `convert`,
which writes an orbax checkpoint and so needs JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from geomconsistentfr_torch.config import PRECISION_TIERS

# What is refused, and the ROADMAP queue 1 item that will port it.
NOT_PORTED = {
    "train": "training from the CLI is ROADMAP queue 1 item 5",
    "build-cache": "the cache builder is ROADMAP queue 1 item 5",
    "crop": "face cropping (S3FD) is ROADMAP queue 1 item 6",
    "convert": "convert writes an orbax checkpoint, which needs JAX; the port reads the reference .pth as it is",
    "lpips": "LPIPS is ROADMAP queue 1 item 6; without --lpips-* eval-multipie reports MSE, DSSIM and PSNR",
    "parallel": "the multi-rank launch from the CLI is ROADMAP queue 1 item 8",
}


def refuse(what: str) -> None:
    raise SystemExit(f"not ported to geomconsistentfr_torch: {NOT_PORTED[what]}")


def _add_common_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint", required=True, help="reference .pth state dict")
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
    p.add_argument("--sample-parallel", action="store_true", help="not ported (ROADMAP queue 1 item 8)")


def _relighter(args, default_preset: str):
    from geomconsistentfr_torch.config import PRESETS, apply_precision_tier, load_config
    from geomconsistentfr_torch.infer import load_relighter, resolve_device

    if getattr(args, "data_parallel", False) or getattr(args, "sample_parallel", False):
        refuse("parallel")
    device = resolve_device(args.device)
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
    return load_relighter(args.checkpoint, cfg=cfg, device=device)


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
    paths = save_visual_pack(args.out, _stem(args.input), pack)
    print(json.dumps({
        "outputs": paths,
        "estimated_direction": [float(v) for v in unit[0].cpu()],
        "estimated_ambient": float(ambient[0]),
    }))
    return 0


def cmd_eval_multipie(args) -> int:
    from geomconsistentfr_torch.metrics.eval_multipie import evaluate_output_dir, run_inference

    if any((args.lpips_trunk, args.lpips_net, args.lpips_lin, args.lpips_random_trunk)):
        refuse("lpips")
    print("note: LPIPS skipped (not ported yet); reporting masked MSE/DSSIM/PSNR only", file=sys.stderr)
    root = args.data_root
    gt_dir = os.path.join(root, "groundtruth_images_MP_18_lightings")
    mask_dir = os.path.join(root, "MP_depth_masks_fill_nose")
    n = 0
    if not args.eval_only:  # --eval-only re-scores an existing dump without the device
        rl = _relighter(args, "multipie_eval")
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
    metrics = evaluate_output_dir(args.out, gt_dir, mask_dir)
    metrics["num_inferred"] = n
    print(json.dumps(metrics))
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
    p.add_argument("--data-parallel", action="store_true", help="not ported (ROADMAP queue 1 item 8)")
    p.add_argument("--eval-only", action="store_true",
                   help="skip inference: re-score the existing dump in --out (the checkpoint is not loaded)")
    for flag in ("--lpips-trunk", "--lpips-net", "--lpips-lin"):
        p.add_argument(flag, default=None, help="not ported (LPIPS, ROADMAP queue 1 item 6)")
    p.add_argument("--lpips-random-trunk", action="store_true", help="not ported (LPIPS, ROADMAP queue 1 item 6)")
    p.set_defaults(fn=cmd_eval_multipie)

    p = sub.add_parser("fix-border", help="border-artifact median fix")
    p.add_argument("--image", required=True)
    p.add_argument("--mask", required=True)
    p.add_argument("--out-image", default=None)
    p.set_defaults(fn=cmd_fix_border)

    p = sub.add_parser("config", help="print a fully resolved preset config as JSON")
    p.add_argument("--preset", default="single_image", help="preset name (see config.PRESETS)")
    p.add_argument("--config", default=None, help="JSON overrides to resolve")
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("bench", help="throughput benchmark on the card (one JSON line)")
    p.set_defaults(fn=cmd_bench)

    refused = ("train", "build-cache", "crop", "convert")
    for name in refused:
        sub.add_parser(name, help=f"not ported: {NOT_PORTED[name]}")

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in refused:
        refuse(argv[0])
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

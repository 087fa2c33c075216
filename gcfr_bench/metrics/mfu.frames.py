"""mfu.frames: the detect-crop-relight job's operations on the window's calls, over the window,
as a share of the float32 peak. Each frame costs S3FD's convolutions at the frame's padded size
(work_s3fd.s3fd_flops: direct convolution; a Winograd or FFT algorithm does fewer
multiplications, so a share read off such an algorithm's time counts work it skipped), each
relit crop what mfu.relight counts for an image: RelightNet's forward from the architecture
table at the render's size, and the march over the crop's face pixels."""

from gcfr_bench import work, work_s3fd


def read(run):
    w, drv = run.window, run.driver
    cfg = drv.cfg["pipeline"]
    r = cfg["render"]
    pad = drv.cfg["s3fd"]["frame_pad"]
    side = drv.frame_size + 2 * pad
    flops = (w["calls"] * drv.batch * work_s3fd.s3fd_flops(side, side)
             + w["cnn_images"] * work.relightnet_flops(cfg["model"]["variant"], r["img_height"], r["img_width"])
             + work.march_ops(w["face_pixels"], r["num_sample_points"], work.veto(r)))
    return 100.0 * flops / w["seconds"] / work.PEAK_F32_FLOPS

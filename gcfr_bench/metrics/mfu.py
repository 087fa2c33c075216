"""mfu.<split> (relight, sweep): the model's operations on the window's images, over the
window, as a share of the float32 peak. The CNN's come from the architecture table at the cell's
shapes, once per image the CNN ran (once per sweep); the march's from the
face pixels of every image relit, the samples and the veto."""

from gcfr_bench import work


def read(run):
    w, cfg = run.window, run.driver.cfg["pipeline"]
    r = cfg["render"]
    flops = (w["cnn_images"] * work.relightnet_flops(cfg["model"]["variant"], r["img_height"], r["img_width"])
             + work.march_ops(w["face_pixels"], r["num_sample_points"], work.veto(r)))
    return 100.0 * flops / w["seconds"] / work.PEAK_F32_FLOPS

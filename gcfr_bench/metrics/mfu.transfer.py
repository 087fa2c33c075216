"""mfu.transfer: the lighting transfer's operations on the window's pairs, over the window, as a
share of the float32 peak. Each input costs RelightNet's whole forward, each reference only its
encoder and lighting head (the light's estimate needs no decoder, so the decoders that the
estimate pass runs count as no work), both from the architecture table at the cell's shapes;
the march's from the face pixels of every input relit, the samples and the veto."""

from gcfr_bench import work


def read(run):
    w, cfg = run.window, run.driver.cfg["pipeline"]
    r, variant = cfg["render"], cfg["model"]["variant"]
    h, wd = r["img_height"], r["img_width"]
    flops = (w["cnn_images"] * work.relightnet_flops(variant, h, wd)
             + w["images"] * work.relightnet_encoder_flops(variant, h, wd)
             + work.march_ops(w["face_pixels"], r["num_sample_points"], work.veto(r)))
    return 100.0 * flops / w["seconds"] / work.PEAK_F32_FLOPS

"""mfu.train: the model's operations of the window's steps, over the window, as a share of
the float32 peak: the CNN's forward and backward of G and D (work.train_step_flops, from
the architecture table), the argmin march and its backward on the face pixels of every
batch the window trained on."""

from gcfr_bench import work


def read(run):
    w, cfg = run.window, run.driver.cfg["pipeline"]
    r = cfg["render"]
    step = sum(work.train_step_flops(cfg["model"]["variant"], cfg["train"]["batch_size"],
                                     r["img_height"], r["img_width"]).values())
    march = (work.march_ops(w["face_pixels"], r["num_sample_points"], work.veto(r), argmin=True)
             + work.march_grad_ops(w["face_pixels"]))
    return 100.0 * (w["steps"] * step + march) / w["seconds"] / work.PEAK_F32_FLOPS

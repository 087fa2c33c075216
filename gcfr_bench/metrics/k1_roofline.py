"""k1_roofline: K1's least time over its device time in the traced stretch.

K1 is csrc/march.cu's march_kernel in its plain form (template form 0). The
least time is the larger of its operations over the float32 peak and its
bytes over HBM's: face pixels x samples x the veto's operations per sample
plus the per-pixel setup, and depth, mask and distances once each with the
lights and the t table."""

import re

from gcfr_bench import work

K1 = re.compile(r"\bmarch_kernel<\s*0\s*,")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    seconds = tr.device_seconds(lambda n: K1.search(n) is not None)
    if seconds <= 0:
        return None
    r = run.driver.cfg["pipeline"]["render"]
    s = r["num_sample_points"]
    ops = work.march_ops(tr.info["face_pixels"], s, work.veto(r))
    nbytes = work.march_bytes(tr.info["images"], r["img_height"], r["img_width"], s)
    return 100.0 * work.least_seconds(ops, nbytes) / seconds

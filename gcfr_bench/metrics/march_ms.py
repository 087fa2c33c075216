"""march_ms.<split> (relight, sweep, train): device time a call of the kernels that
csrc/march.cu defines (staging, the march and its backward), from the traced stretch,
matched by name. A training cell's call is one optimizer step."""

import re

KERNELS = re.compile(r"\b(march_kernel|stage_kernel|march_grad_kernel|unpack_key_kernel)\b")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    s = tr.device_seconds(lambda n: KERNELS.search(n) is not None)
    return 1e3 * s / tr.info["calls"] if s > 0 else None

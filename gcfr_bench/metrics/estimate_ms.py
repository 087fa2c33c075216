"""estimate_ms.<split> (transfer): `Relighter.estimate_lighting` called alone on a batch of the
cell's references, timed with CUDA events after the window (ms a call)."""


def read(run):
    if run.driver.device.type != "cuda":
        return None
    return run.driver.estimate_ms()

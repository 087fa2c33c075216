"""cnn_ms.<split> (relight, sweep): the Relighter's CNN called alone at the cell's CNN
batch (the batch, or 1 for a sweep), timed with CUDA events after the window (ms a call)."""


def read(run):
    if run.driver.device.type != "cuda":
        return None
    return run.driver.cnn_ms()

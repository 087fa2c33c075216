"""serve.device_ms_per_batch: the server worker's span from a batch's dispatch to its copy's
end (CUDA events), a batch, over the window, from /statz's `device_seconds` and `batches`."""


def read(run):
    d = run.window["statz"]
    return 1e3 * d["device_seconds"] / d["batches"] if d["batches"] else None

"""serve.batch_rows: real rows a batch over the window, from the server's /statz
(the change in `batched_rows` over the change in `batches`)."""


def read(run):
    d = run.window["statz"]
    return d["batched_rows"] / d["batches"] if d["batches"] else None

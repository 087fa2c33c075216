"""detect_d2h_kb.<split> (frames): kilobytes (1000 bytes) that detection copies to the host a
frame over the traced stretch, from the program's counters (utils/profiling.COUNTS:
detect.d2h_bytes over detect.frames), as the driver's trace records their change."""


def read(run):
    counts = None if run.trace is None else run.trace.info.get("counts")
    if not counts or not counts.get("detect.frames"):
        return None
    return counts["detect.d2h_bytes"] / counts["detect.frames"] / 1e3

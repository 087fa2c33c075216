"""detect_trunk_ms.<split> (frames): device ms a call launched inside the program's
gcfr.detect.trunk span (S3FD's VGG16, fc6/fc7, the extras, L2Norm and the twelve head
convolutions at the call's batch), from the stretch of gcfr_bench/spans.py."""

from gcfr_bench import spans


def read(run):
    split = spans.program_split(run)
    return None if split is None else split.device_ms("gcfr.detect.trunk")

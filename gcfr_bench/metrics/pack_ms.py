"""pack_ms.<split> (relight): device ms a call launched inside the program's gcfr.pack span
(the uint8 visual pack), from the stretch of gcfr_bench/spans.py."""

from gcfr_bench import spans


def read(run):
    split = spans.program_split(run)
    return None if split is None else split.device_ms("gcfr.pack")

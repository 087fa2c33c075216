"""program_idle_ms.<split> (relight): device idle ms a call in gaps that began while one of
the program's gcfr.* spans was the innermost open on the host, from the stretch of
gcfr_bench/spans.py."""

from gcfr_bench import spans


def read(run):
    split = spans.program_split(run)
    return None if split is None else split.program_idle_ms()

"""detect_post_ms.<split> (frames): the device ms a call launched inside the program's
gcfr.detect.decode (softmax, threshold, decode, the candidates' copy to the host),
gcfr.detect.nms and gcfr.crop spans, from the stretch of gcfr_bench/spans.py: the card's own
work in detection's post-processing. The idle the host's part leaves on the card is
program_idle_ms's."""

from gcfr_bench import spans

SPANS = ("gcfr.detect.decode", "gcfr.detect.nms", "gcfr.crop")


def read(run):
    split = spans.program_split(run)
    if split is None or not split.names.intersection(SPANS):
        return None
    return split.device_ms(*SPANS)

"""cnn_encoder_ms.<split> (relight): device ms a call launched inside the program's
gcfr.cnn.encoder span (RelightNet's encoder, c1_og to h4), from the stretch of
gcfr_bench/spans.py."""

from gcfr_bench import spans


def read(run):
    split = spans.program_split(run)
    return None if split is None else split.device_ms("gcfr.cnn.encoder")

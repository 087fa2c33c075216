"""cnn_decoders_ms.<split> (relight): device ms a call launched inside the program's
gcfr.cnn.decoder_albedo and gcfr.cnn.decoder_depth spans (RelightNet's two decoders), from
the stretch of gcfr_bench/spans.py."""

from gcfr_bench import spans


def read(run):
    split = spans.program_split(run)
    return None if split is None else split.device_ms("gcfr.cnn.decoder_albedo", "gcfr.cnn.decoder_depth")

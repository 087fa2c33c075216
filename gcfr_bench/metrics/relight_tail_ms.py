"""relight_tail_ms.<split> (frames): device ms a call launched inside the spans of
`Relighter.forward_visuals` on the crops (gcfr.upload, the CNN's gcfr.cnn.*, gcfr.render and
its march, gcfr.pack), from the stretch of gcfr_bench/spans.py."""

from gcfr_bench import spans

SPANS = ("gcfr.upload", "gcfr.cnn", "gcfr.cnn.encoder", "gcfr.cnn.lighting_head", "gcfr.cnn.decoder_albedo",
         "gcfr.cnn.decoder_depth", "gcfr.render", "gcfr.render.march", "gcfr.pack")


def read(run):
    split = spans.program_split(run)
    return None if split is None else split.device_ms(*SPANS)

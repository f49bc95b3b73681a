"""The share of the window's samples whose target model the cache held
(the port's `tmodel_hits` and `tmodel_misses` counters, per sample as
build_disc_batch counts them), in percent."""


def read(context):
    counts = context.get("program_counts", {})
    hits, misses = counts.get("tmodel_hits"), counts.get("tmodel_misses", 0)
    if hits is None or hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)

"""cache_hit_rate.eval: the device image cache's hits over its lookups
(distinct images a batch), in percent, over the traced calls: the
program's counters `ekaid.cache.hits` and `ekaid.cache.misses`. Nothing
where the eval reads the wire batches (no cache)."""

from benchlib.spans import recorded, share


def read(ctx):
    return share(recorded(ctx), "ekaid.cache.hits", "ekaid.cache.misses")

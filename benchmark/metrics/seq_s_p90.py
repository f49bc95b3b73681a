"""The 90th percentile of the window's sequences' seconds (frames over fps,
init included), by statistics.quantiles' exclusive method."""
import statistics


def read(context):
    s = [r["seconds"] for r in context["records"]]
    return statistics.quantiles(s, n=10)[8] if len(s) >= 2 else None

"""The share of the PNG work that the loop's thread does not wait for, in
percent: 100 x (1 - the wall of the window's `png_write` spans (the loop
handing a sequence's labels to the writer, a wait while its queue is full,
the wait for every write after run_dataset's last sequence) / the wall of
its `png_encode` spans (the writer threads' encoding and writing)). None
where the port wrote no `png_encode` span."""
from benchmark.metrics._program import window


def read(context):
    got = window(context)
    if got is None:
        return None
    wall = {"png_write": 0, "png_encode": 0}
    for s in got[0]:
        if s.name in wall:
            wall[s.name] += s.end_ns - s.start_ns
    if not wall["png_encode"]:
        return None
    return 100.0 * (1.0 - wall["png_write"] / wall["png_encode"])

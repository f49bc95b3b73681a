"""One-ahead background-thread iteration (frtm_tpu/utils/prefetch.py): the
generator's body (dataset reads, frame decode, first-frame augmentation,
uploads) runs on one worker thread while the consumer tracks the previous
element.

Only the worker thread ever touches the wrapped iterator, so whatever it
draws or computes happens in the order it would inline: a prefetched
pipeline gives its serial form's results."""
from concurrent.futures import ThreadPoolExecutor


def prefetch_iter(it, enabled=True):
    """Yield from `it`, computing one element ahead on a background thread.

    enabled=False degrades to plain iteration (the serial reference
    behavior). The worker pool is a context manager, so an exception in the
    consumer closes the generator and joins the in-flight prefetch instead
    of leaking the thread and its (potentially hundreds of MB) result."""
    it = iter(it)
    if not enabled:
        yield from it
        return
    done = object()
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(next, it, done)
        while True:
            val = fut.result()
            if val is done:
                return
            fut = pool.submit(next, it, done)
            yield val

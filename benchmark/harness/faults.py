"""Faults planted under a tracking cell's timed path, which the check has to
find. Each takes `patch(owner, name, value)` (pytest's monkeypatch.setattr,
or spans.Patches.set) and plants one fault in the port's fused tracker;
control.py reads them on the card, the tests at a tiny size."""


def zero_labels(patch):
    """An answer altered where it is produced: every tracked label background."""
    import torch
    from frtm_tpu_torch.runtime import sequence_tracker as st
    merge = st.merge_rows_and_label

    def altered(rows, lut):
        merged, label = merge(rows, lut)
        return merged, torch.zeros_like(label)
    patch(st, "merge_rows_and_label", altered)


def half_batch(patch):
    """Half of the batch left out, the mean taken over the rest: a filter
    re-solve with every other memory slot at weight 0 and the rest's weights
    renormalised."""
    from frtm_tpu_torch.runtime import sequence_tracker as st
    inner = st.resolve_due

    def halved(params, state, due, cfg):
        w = state.memory.weights
        keep = w.clone()
        w[:, 1::2] = 0
        w /= w.sum(1, keepdim=True).clamp_min(1e-12)
        out = inner(params, state, due, cfg)
        w.copy_(keep)
        return out
    patch(st, "resolve_due", halved)


def unchanged_state(patch):
    """A step that returns its state unchanged: the filter re-solve hands
    back the filters it was given."""
    from frtm_tpu_torch.runtime import sequence_tracker as st
    patch(st, "resolve_due", lambda params, state, due, cfg: params)


def insert_skipped(patch):
    """The memory inserts left out: a tracked frame only advances the
    frame counters, so every re-solve reads the init's samples alone."""
    from frtm_tpu_torch.runtime import sequence_tracker as st

    def skipped(state, compressed, train_y, enabled, active, cfg):
        state.frame_num = [f + bool(a) for f, a in zip(state.frame_num, active)]
    patch(st, "insert_sample", skipped)


def filters_discarded(patch):
    """The re-solved filters left unused: every window of a sequence is
    classified with the filters of its first."""
    from frtm_tpu_torch.runtime import sequence_tracker as st
    track, classify = st.BatchedSequenceTracker._track, st.classify_objects
    held = {}

    def tracking(self, *args, **kwargs):
        held.clear()
        return track(self, *args, **kwargs)

    def stale(compressed, filters, clamp_output=False):
        if "filter" not in held:
            held["filter"] = filters.clone()
        return classify(compressed, held["filter"], clamp_output=clamp_output)
    patch(st.BatchedSequenceTracker, "_track", tracking)
    patch(st, "classify_objects", stale)


FAULTS = {f.__name__: f for f in (zero_labels, half_batch, unchanged_state, insert_skipped,
                                  filters_discarded)}

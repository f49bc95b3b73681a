"""`init_replay_pct`'s reader on fabricated counts: the window's requests'
replays over their inits, the warm-up's left out; nothing where the port
counts no init replay (a port without the init graphs), where the window
made no init, or where the recorder is missing."""
import pytest

from benchmark.harness import core
from frtm_tpu_torch.utils import profiling
from frtm_tpu_torch.utils.profiling import Span

MS = 1_000_000


def _recorded(monkeypatch, counts):
    """A warm-up sequence (w#0) and the window's two (a#1, b#2); `counts`:
    {request: {counter: n}}."""
    spans = [Span("run_sequence", t * 1000 * MS, (t + 1) * 1000 * MS, 0, 11, -1, r)
             for t, r in enumerate(("w#0", "a#1", "b#2"))]

    def summed(requests=None):
        out = {}
        for r, named in counts.items():
            if requests is None or r in requests:
                for k, n in named.items():
                    out[k] = out.get(k, 0) + n
        return out
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "counts", summed)
    return {"records": [{"frames": 9, "objects": 1}, {"frames": 17, "objects": 3}]}


@pytest.mark.parametrize("counts,want", [
    ({"w#0": {"inits": 1, "init_replays": 0}, "a#1": {"inits": 1, "init_replays": 1},
      "b#2": {"inits": 1, "init_replays": 1}}, 100.0),
    ({"w#0": {"inits": 1, "init_replays": 1}, "a#1": {"inits": 1, "init_replays": 0},
      "b#2": {"inits": 1, "init_replays": 1}}, 50.0),
    ({"a#1": {"inits": 1, "init_replays": 0}, "b#2": {"inits": 1}}, 0.0),
    ({"w#0": {"init_replays": 1}, "a#1": {"inits": 1}, "b#2": {"inits": 1}}, None),
    ({"a#1": {"init_replays": 0, "resolves": 2}, "b#2": {"resolve_replays": 2}}, None)])
def test_init_replay_share_of_the_windows_inits(monkeypatch, counts, want):
    got = core.reader("init_replay_pct")(_recorded(monkeypatch, counts))
    assert got == (None if want is None else pytest.approx(want))


def test_init_replay_share_is_silent_without_the_recorder(monkeypatch):
    ctx = _recorded(monkeypatch, {"a#1": {"inits": 1, "init_replays": 1}})
    monkeypatch.delattr(profiling, "spans")
    assert core.reader("init_replay_pct")(ctx) is None

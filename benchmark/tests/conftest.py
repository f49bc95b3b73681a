"""The benchmark's own tests run on the CPU at a tiny size, with the port's
kernels in their plain versions: `python -m pytest benchmark/tests -q`."""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# a tiny tracking cell: resnet18 in float32 at 64x96, three short sequences
# in chunks of two (one with two objects), long enough for a re-solve
TINY = {"config": {"arch": "resnet18", "compute_dtype": "float32"},
        "mix": {"frame_size": [64, 96], "chunk_sequences": 2,
                "sequences": [{"name": "a", "frames": 11, "objects": [[20, 24]]},
                              {"name": "b", "frames": 10, "objects": [[16, 20], [14, 18]]},
                              {"name": "c", "frames": 12, "objects": [[18, 26]]}]}}


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

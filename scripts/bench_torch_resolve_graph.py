#!/usr/bin/env python3
"""The target model's filter re-solve (`resolve_due`) at the eval widths on one
CUDA card, run eagerly and replayed as a CUDA graph, at 1 to 5 objects.

    python3 scripts/bench_torch_resolve_graph.py [--out FILE] [--repeats R]

Per lane count N, on a full memory of the rn101 eval configuration (80 slots
of 96 x 30 x 54 compressed samples, 480 x 854 labels and pixel weights, 10
CG steps): the host's milliseconds to issue one call (from an idle card, no
synchronise inside; the machine's thread-CPU clock ticks in 10 ms), the wall
milliseconds of one call synchronised at both ends, and the card's kernel
milliseconds of one call (torch.profiler's sum over its kernels and copies),
eagerly (a graph cache of size 0) and replayed; the capture's seconds and the
device memory the key's graph holds (allocated and reserved, each read after
emptying the allocator's cache, before and after the capture); the bytes
a replay copies into the graph's static inputs and the card's milliseconds
for those copies (CUDA events); and whether the replayed filter and CG state
equal the eager ones bit for bit. Prints the card's name and power limit,
then one JSON line per N, and writes them all to FILE (default
build/resolve_graph.json).
"""
import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def full_memory(n, cfg, seed):
    """DiscParams and a DiscState of n lanes on a memory with every slot
    filled: seeded samples and boxes, the eval weighting of the boxes."""
    import torch
    from frtm_tpu_torch.models import discriminator as td
    from frtm_tpu_torch.models.memory import MemoryState
    from frtm_tpu_torch.models.solver import init_cg_state
    g = torch.Generator().manual_seed(seed)
    S, c, h, w, H, W = cfg.memory_size, cfg.c_channels, 30, 54, 480, 854
    labels = torch.zeros((n, S, 1, H, W))
    for i in range(n):
        for k in range(S):
            y = int(torch.randint(0, H - H // 3, (1,), generator=g))
            x = int(torch.randint(0, W - W // 3, (1,), generator=g))
            labels[i, k, 0, y:y + H // 3, x:x + W // 3] = 1.0
    labels = labels.cuda()
    weights = torch.rand((n, S), generator=g) + 0.5
    memory = MemoryState(samples=torch.randn((n, S, c, h, w), generator=g).cuda(),
                         labels=labels, pixel_weights=td.compute_pixel_weights(labels, cfg),
                         weights=(weights / weights.sum(1, keepdim=True)).cuda(),
                         current_size=torch.full((n,), S, device="cuda"),
                         prev_ind=torch.zeros(n, dtype=torch.int64, device="cuda"))
    filt = (torch.randn((n, cfg.out_channels, c, 3, 3), generator=g) * 0.01).cuda()
    state = td.DiscState(memory=memory, cg=init_cg_state((filt,)), frame_num=[0] * n,
                         n_resolves=torch.zeros(n, dtype=torch.int64, device="cuda"))
    return td.DiscParams(project=None, filter=filt), state


def copy_state(state):
    cg = state.cg
    return replace(state, cg=replace(cg, p=tuple(t.clone() for t in cg.p),
                                     r_prev=tuple(t.clone() for t in cg.r_prev),
                                     rho=cg.rho.clone(), have_p=cg.have_p.clone(),
                                     step_alpha=cg.step_alpha.clone()))


def kernel_ms(fn):
    """The card's milliseconds of fn's kernels, copies and sets."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    return us / 1e3


def readings(n, cfg, repeats):
    import torch
    from frtm_tpu_torch.models import discriminator as td
    from frtm_tpu_torch.utils.cuda_graphs import GraphCache
    params, state0 = full_memory(n, cfg, seed=n)
    due = torch.tensor([k % 2 == 0 for k in range(n)], device="cuda")
    out = {"objects": n}

    def timed(state):
        host, wall = [], []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            td.resolve_due(params, state, due, cfg)
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        return sorted(host)[len(host) // 2], sorted(wall)[len(wall) // 2]

    td.RESOLVE_GRAPHS = GraphCache(0)
    eager_state = copy_state(state0)
    eager = td.resolve_due(params, eager_state, due, cfg)
    out["eager_host_ms"], out["eager_wall_ms"] = timed(copy_state(state0))
    out["eager_kernel_ms"] = kernel_ms(lambda: td.resolve_due(params, copy_state(state0), due,
                                                                  cfg))

    cache = td.RESOLVE_GRAPHS = GraphCache(16)
    td.resolve_due(params, copy_state(state0), due, cfg)            # the key's first call
    graphed_state = copy_state(state0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    graphed = td.resolve_due(params, graphed_state, due, cfg)      # capture and replay
    torch.cuda.synchronize()
    out["capture_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    out["graph_allocated_bytes"], out["graph_reserved_bytes"] = (after[0] - before[0],
                                                                 after[1] - before[1])
    out["same_bits"] = bool(torch.equal(graphed.filter, eager.filter)) and all(
        torch.equal(a, b) for a, b in ((graphed_state.cg.p[0], eager_state.cg.p[0]),
                                       (graphed_state.cg.r_prev[0], eager_state.cg.r_prev[0]),
                                       (graphed_state.cg.rho, eager_state.cg.rho),
                                       (graphed_state.cg.step_alpha, eager_state.cg.step_alpha)))
    out["filter_max_gap"] = float((graphed.filter - eager.filter).abs().max())
    out["replay_host_ms"], out["replay_wall_ms"] = timed(copy_state(state0))
    out["replay_kernel_ms"] = kernel_ms(lambda: td.resolve_due(params, copy_state(state0), due,
                                                                   cfg))
    graph, = (g for g in cache._graphs.values() if g is not None)
    out["copy_bytes"] = sum(t.numel() * t.element_size() for t in graph.inputs)
    inputs = [t.clone() for t in graph.inputs]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        for static, t in zip(graph.inputs, inputs):
            static.copy_(t)
    end.record()
    torch.cuda.synchronize()
    out["copy_ms"] = start.elapsed_time(end) / repeats
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "resolve_graph.json")
    ap.add_argument("--repeats", type=int, default=9)
    args = ap.parse_args()
    import torch
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.device import resolve_device
    resolve_device("cuda")
    torch.set_num_threads(2)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lines = [{"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}]
    print(json.dumps(lines[0]), flush=True)
    cfg = eval_config("resnet101").disc
    with torch.no_grad():
        for n in range(1, 6):
            lines.append(readings(n, cfg, args.repeats))
            print(json.dumps(lines[-1]), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()

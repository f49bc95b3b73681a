"""How `correct` is decided for a tracking cell.

The random-weight tracker is chaotic: a bfloat16 rounding moves its GN-CG
init's filters a fifth of their peak, and the port's labels drift from the
float32 reference's within a sequence, while the port in float32 matches it
to a few pixels. So the check compares the start from scratch and follows
the port from its own state over the stages that the start does not reach,
in four numbers (limits/<cell>.json holds their limits):

* `clear_error`, the labels. Once the window has closed, the reference
  (benchmark/reference/: the plain tracker in float32, TF32 off, with its own
  weights made again from the configuration's weight seed and the same head
  scale) tracks a sample of the window's sequences from the same generated
  frames: the longest that the window finished and the one whose re-solve
  was captured (below). Its first-frame augment (plain warps, the Python
  Telea inpaint), GN-CG init, backbone, decoder (plain kernels 1 and 2) and
  merge are its own. Over the frames before the first filter re-solve, and
  over the window after the captured re-solve (below), `clear_error` is the
  share of the pixels whose winner leads the runner-up by MARGIN in the
  reference's probabilities that the port labels otherwise. What is judged
  is the labels that the port's run_sequence returned in the window, the
  ones it wrote as PNGs.
* `memory_gap`, the memory inserts. The first filter re-solve of the
  captured sequence (one of the window's first three, drawn from the seed)
  is captured from the port's timed `resolve_due` with its inputs: the
  port's memory after the window's inserts, its CG state, its target
  models. The reference follows the frames before it from the port's
  starting target models and makes its own inserts (the compressed
  features of the frames whose mask holds 10 foreground pixels); the worst
  object's |s - s_ref| / |s_ref| of the features in the slots after the
  init's, and of the slot weights against the reference's own tracking's,
  is `memory_gap`. (The stored soft masks are printed, not compared: a
  merged mask jumps from 0 to about 0.5 where its object starts to win, so
  bfloat16 rounding moves it by half at the many pixels near a tie.)
* `resolve_gap`, the re-solve: the reference's filter_resolve of the
  captured inputs against the filters that the port's re-solve returned,
  |f - f_ref| / |f_ref|, the worst lane due.
* `follow_gap`, the window after the re-solve: the reference tracks the
  next window of that sequence with the port's projections and its own
  re-solve of the captured inputs (the lanes not due keep their filters),
  and `follow_gap` is the share of the pixels whose winner leads the
  runner-up by FOLLOW_MARGIN that the port labels otherwise (at MARGIN they
  count in `clear_error` too). With the target models handed over, only the
  backbone's and decoder's rounding part the two, so a smaller margin
  holds: a port that leaves its re-solved filters unused labels that window
  otherwise.

Each value is the worst over what was sampled. The control (`control=True`)
is the reference in the port's place, a step below the configuration's
precision: float8 operands in the backbone's and decoder's convolutions, a
bfloat16 target model and re-solve; its four numbers are then the ones
compared. The readings that each limit lies between are in PERF.md.
"""
import time

import numpy as np
import torch

# the margin by which the reference's winner leads the runner-up at the
# pixels that `follow_gap` counts (PERF.md: the readings it was chosen from)
FOLLOW_MARGIN = 0.2


class StateCapture:
    """Wraps the port's `resolve_due` (as the fused tracker calls it) and, once
    armed, keeps copies of the inputs of the next re-solve that a lane takes
    (the target models, the memory's samples, labels and weights, the CG
    state, the lanes due, the frame) and of the filters it returned."""

    def __init__(self):
        self.armed = False
        self.seq_index = None
        self.taken = None

    def arm(self, seq_index: int):
        self.armed, self.seq_index = True, seq_index

    def install(self, patches):
        from frtm_tpu_torch.runtime import sequence_tracker as st
        inner = st.resolve_due

        def capturing(params, state, due, cfg):
            # a re-solve that no lane takes is passed over (one host read)
            if not self.armed or not bool(due.any()):
                return inner(params, state, due, cfg)
            self.armed = False
            m, cg = state.memory, state.cg
            before = dict(filter=params.filter.clone(), project=params.project.clone(),
                          samples=m.samples.clone(), labels=m.labels.clone(),
                          pixel_weights=m.pixel_weights.clone(), weights=m.weights.clone(),
                          p=tuple(t.clone() for t in cg.p),
                          r_prev=tuple(t.clone() for t in cg.r_prev), rho=cg.rho.clone(),
                          have_p=cg.have_p.clone(), step_alpha=cg.step_alpha.clone(),
                          due=due.clone(), frame=max(state.frame_num),
                          seq_index=self.seq_index)
            out = inner(params, state, due, cfg)
            self.taken = dict(before, result=out.filter.clone())
            return out
        patches.set(st, "resolve_due", capturing)


def reference_resolve(taken, rcfg, round_bf16=False):
    """The reference's filter_resolve of the captured inputs (their bfloat16
    roundings, for the control): (N, ...) filters."""
    from ..reference.discriminator import DiscParams, DiscState, filter_resolve
    from ..reference.memory import MemoryState
    from ..reference.solver import CGState
    q = (lambda t: t.bfloat16().float()) if round_bf16 else (lambda t: t.float())
    N = taken["weights"].shape[0]
    mem = MemoryState(samples=q(taken["samples"]), labels=q(taken["labels"]),
                      pixel_weights=q(taken["pixel_weights"]), weights=q(taken["weights"]),
                      current_size=torch.zeros(N, dtype=torch.int64),
                      prev_ind=torch.zeros(N, dtype=torch.int64))
    cg = CGState(p=tuple(map(q, taken["p"])), r_prev=tuple(map(q, taken["r_prev"])),
                 rho=q(taken["rho"]), have_p=taken["have_p"], step_alpha=q(taken["step_alpha"]))
    state = DiscState(memory=mem, cg=cg, frame_num=[0] * N,
                      n_resolves=torch.zeros(N, dtype=torch.int64))
    ref, _ = filter_resolve(DiscParams(None, q(taken["filter"])), state, rcfg.disc)
    return ref.filter


def resolve_gap(got, ref, due):
    """The largest, over the lanes due, of |f - f_ref| / |f_ref| (Frobenius)."""
    gaps = [float((got[i].float() - ref[i]).norm() / ref[i].norm())
            for i in range(due.shape[0]) if bool(due[i])]
    return max(gaps) if gaps else None


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def memory_gap(got, want):
    """(the worst object's larger of the inserted features' and the slot
    weights' relative gap, the worst inserted masks' gap): got and want hold
    one (inserted features, inserted masks, slot weights) an object; an
    object whose inserts differ in number reads 1."""
    feats, masks = [], []
    for (f, m, w), (fr, mr, wr) in zip(got, want):
        if fr is None or f.shape != fr.shape:
            same = fr is None and f.shape[0] == 0
            feats.append(max(0.0 if same else 1.0, _rel(w, wr)))
            masks.append(0.0 if same else 1.0)
            continue
        feats.append(max(_rel(f, fr), _rel(w, wr)))
        masks.append(_rel(m, mr))
    return max(feats), max(masks)


def sample(records, seed: int, also=None) -> list:
    """Indices of the sequences to check: the longest the window finished
    (the first of them) and `also`, or where that is None or the longest,
    one drawn from the seed."""
    if not records:
        return []
    longest = min(range(len(records)), key=lambda i: (-records[i]["frames"], i))
    if also is not None and also != longest and also < len(records):
        return [longest, also]
    rest = [i for i in range(len(records)) if i != longest]
    if not rest:
        return [longest]
    rng = np.random.default_rng([int(seed) % (1 << 64), 3])
    return [longest, rest[int(rng.integers(len(rest)))]]


def check_tracking(config, rcfg, limits, records, seed, head, device, control=False,
                   taken=None):
    """({number: (value, limit)} for each number limits/<cell>.json names,
    notes). `taken`: a StateCapture's capture. control: the control's
    numbers are the ones compared (the port's go into the notes)."""
    from ..reference.tracker import MARGIN, ReferenceTracker
    from . import track, weights as wt
    t0 = time.perf_counter()
    bsd, rsd, disc0, ch = track.make_weights(config, device)
    wt.scale_head(rsd, *head)
    backbone, refiner = track.reference_modules(config, bsd, rsd, ch, device)
    ref = ReferenceTracker(rcfg, backbone, refiner, disc0, device)
    who = ["port"]
    ctl = None
    if control:
        cb, cr = track.reference_modules(config, bsd, rsd, ch, device)
        cb.fp8 = cr.fp8 = True
        ctl = ReferenceTracker(rcfg, cb, cr, disc0, device, tm_bf16=True)
        who.append("control")
    notes, worst = [], {}

    def keep(name, by, value):
        if value is not None:
            worst[(by, name)] = max(worst.get((by, name), value), value)

    first = max(int(rcfg.disc.train_skipping), 1)
    captured = taken["seq_index"] if taken is not None else None
    for i in sample(records, seed, captured):
        rec = records[i]
        seq = rec["sequence"]
        frames, first_labels = seq.frames(), seq.first_labels()
        seq.preloaded = None
        program = np.stack([np.asarray(a, np.uint8) for a in rec["labels"]])
        if program.shape != frames.shape[:3]:
            notes.append(f"check {seq.name}: the port returned {program.shape} for "
                         f"{frames.shape[:3]} frames")
            return {k: (None, lim) for k, lim in limits.items()}, notes
        at = taken["frame"] if i == captured else None
        until = first if at is None else max(first, at)
        judged, memories = {"port": program}, {}
        if ctl is not None:
            judged["control"], _, memories["control"] = ctl.track_sequence(
                frames, first_labels, seq.obj_ids, until=until, memory_at=at)
        _, gaps, mem_ref = ref.track_sequence(frames, first_labels, seq.obj_ids, judged,
                                              until=until, memory_at=at)
        for by, g in gaps.items():
            notes.append(f"{'check' if by == 'port' else by} {seq.name} ({rec['frames']} frames, "
                         f"{rec['objects']} objects, to frame {until}): "
                         + " ".join(f"{k} {v!r}" for k, v in g.items()))
            keep("clear_error", by, g["first_clear_error"])
        if at is None:
            continue
        # the memory after the window's inserts: the reference follows frames
        # 1..at from the port's starting models (the control in the port's
        # place likewise), its inserts against the slots after the init's
        n = len(seq.obj_ids)
        start = frames[1:at + 1]
        _, _, ins_ref = ref.follow_window(start, taken["project"], taken["filter"], seq.obj_ids)
        want = [(f, m, mem[2]) for (f, m), mem in zip(ins_ref, mem_ref)]
        got = {}
        for k, mem in enumerate(mem_ref):
            K, m = mem[3], 0 if ins_ref[k][0] is None else ins_ref[k][0].shape[0]
            got.setdefault("port", []).append((taken["samples"][k][K:K + m],
                                               taken["labels"][k][K:K + m],
                                               taken["weights"][k]))
        if ctl is not None:
            _, _, ins_ctl = ctl.follow_window(start, taken["project"], taken["filter"],
                                              seq.obj_ids)
            got["control"] = [(f, m, mem[2]) for (f, m), mem in
                              zip(ins_ctl, memories["control"])]
        f_port = reference_resolve(taken, rcfg)
        due = taken["due"].reshape((-1,) + (1,) * (f_port.dim() - 1))
        filters = {}
        for by in who:
            gap, mask_gap = memory_gap(got[by], want)
            keep("memory_gap", by, gap)
            if by == "port":
                f = f_port
                keep("resolve_gap", by, resolve_gap(taken["result"], f_port, taken["due"]))
            else:
                f = reference_resolve(taken, rcfg, round_bf16=True)
                keep("resolve_gap", by, resolve_gap(f, f_port, taken["due"]))
            filters[by] = torch.where(due, f, taken["filter"].float())
            notes.append(f"{'check' if by == 'port' else by} {seq.name} at frame {at} "
                         f"({int(taken['due'].sum())} of {n} lanes due): memory_gap {gap!r} "
                         f"stored masks {mask_gap!r} resolve_gap "
                         f"{worst.get((by, 'resolve_gap'))!r}")
        t1 = min(at + first, len(frames) - 1)
        if t1 <= at:
            notes.append(f"check {seq.name}: no frame after the re-solve at frame {at}")
            continue
        after = frames[at + 1:t1 + 1]
        judged = {"port": program[at + 1:t1 + 1]}
        if ctl is not None:
            judged["control"] = ctl.follow_window(after, taken["project"], filters["control"],
                                                  seq.obj_ids)[0]
        _, gaps, _ = ref.follow_window(after, taken["project"], filters["port"], seq.obj_ids,
                                       judged)
        for by, g in gaps.items():
            notes.append(f"{'check' if by == 'port' else by} {seq.name} frames {at + 1}-{t1} "
                         "after the re-solve: " + " ".join(f"{k} {v!r}" for k, v in g.items()))
            keep("clear_error", by, g[f"error_{MARGIN}"])
            keep("follow_gap", by, g[f"error_{FOLLOW_MARGIN}"])
    notes.append(f"reference_s {time.perf_counter() - t0!r}")
    if ctl is not None:
        notes.append("port " + " ".join(f"{k} {worst.get(('port', k))!r}" for k in limits))
    del ref, ctl, backbone, refiner
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    judged_by = who[-1]
    return {k: (worst.get((judged_by, k)), lim) for k, lim in limits.items()}, notes

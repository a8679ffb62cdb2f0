"""The comparison that decides ``correct`` for the monocular entry: what the
timed path produced, held against the plain reference
(``vobench/reference/mono.py``) on the same frames and the same uniforms.

The reference checks

- every set-up step, and a sample of ``check_steps`` window steps drawn
  from the seed, each from the program's own state before it as its
  records give it (the last accepted frame, ``c_T_w``, the skip count,
  whether a frame was accepted yet, and the update's index, which names
  its draw of uniforms), with its own features of those frames;
- the first ``start_steps`` steps alone from the fresh state, composing
  its own poses, which checks the start and the carry;
- the features the program kept for its last accepted frame after each
  sampled unit (``Records.feats``), against its own of that frame.

A frame's features depend on the frame alone, so the reference extracts
each frame shown once.

Numbers compared, each held to its limit (``vobench/limits/<cell>.json``):

- ``kp_mismatch``: the share of keypoint slots whose validity, position
  or descriptor differs;
- ``matches_gap``: the widest gap in a step's matches;
- ``inliers_gap``: the widest gap in a step's inliers, over the steps
  where the reference reached the inlier test;
- ``pose_gap``: the widest gap of an entry of ``c_T_w`` (m for the
  translation); a step whose accept flag, skip code or skip count
  differs reads ``STATE_GAP``.

With ``control`` the reference in lower precision (``low``) takes the
program's place, from the same states: ORB's Harris response and the
essential matrix's layer (five-point solver, Sampson and MSAC sums, the
SVDs' Jacobi) where ``control`` is true; with ``control="ransac"`` the
essential matrix's layer alone, ORB exact, which the ``inliers_gap`` and
``pose_gap`` limits have to tell from the program without ORB's help.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vobench.reference import mono as ref
from vobench.reference.odometry import ORB
from vobench.reference.orb import detect_and_compute

STATE_GAP = 1.0   # m: a wrong accept flag, skip code or skip count
REF_BATCH = 16    # frames the reference extracts at once


class Frames:
    """The reference's features of each frame, extracted in batches."""

    def __init__(self, lefts, orb: ORB, device):
        self.lefts, self.orb = lefts, orb
        self.device = torch.device(device)
        self.cache = {}
        self.seconds = 0.0

    def prefetch(self, frames):
        t0 = time.perf_counter()
        todo = sorted(set(frames) - set(self.cache))
        for a in range(0, len(todo), REF_BATCH):
            part = todo[a:a + REF_BATCH]
            f = detect_and_compute(
                torch.stack([self.lefts[t, 0] for t in part]).to(
                    self.device), None, self.orb)
            for j, t in enumerate(part):
                self.cache[t] = ref.Frame(f["xy"][j], f["desc"][j],
                                          f["valid"][j])
        self.seconds += time.perf_counter() - t0

    def get(self, t) -> ref.Frame:
        if t not in self.cache:
            self.prefetch([t])
        return self.cache[t]


class Follower:
    """The program's state before each row of its records."""

    def __init__(self, rec):
        self.rec = rec
        self.kept = []        # row -> the frame of the last accepted row
        last = None           # up to and including it, or None
        for i, ok in enumerate(rec.success):
            if ok[0]:
                last = rec.frame[i]
            self.kept.append(last)

    def before(self, i: int):
        """(frame of the last accepted row before ``i`` or None, c_T_w,
        skip count)."""
        if i == 0:
            return None, np.eye(4, dtype=np.float32), 0
        return (self.kept[i - 1], self.rec.pose[i - 1][0],
                int(self.rec.skipped[i - 1]))

    def state(self, i: int, frames: Frames, device) -> ref.State:
        t, c_T_w, skipped = self.before(i)
        return ref.State(None if t is None else frames.get(t),
                         torch.as_tensor(c_T_w, device=device), skipped)


@dataclasses.dataclass
class Tally:
    kp_bad: int = 0
    kp_all: int = 0
    matches_gap: int = 0
    inliers_gap: int = 0
    pose_gap: float = 0.0
    steps: int = 0
    skips: int = 0

    def features(self, prog, mine: ref.Frame):
        kp_xy, desc, kp_valid = (x.to(mine.kp_xy.device) for x in prog)
        bad = (kp_valid != mine.kp_valid) | (kp_valid & (
            (kp_xy != mine.kp_xy).any(-1) | (desc != mine.desc).any(-1)))
        self.kp_bad += int(bad.sum())
        self.kp_all += bad.numel()

    def step(self, theirs: tuple, mine: ref.Step, skipped: int, c_T_w):
        """``theirs``: (accept, code, skip count, matches, inliers, c_T_w)
        of the program (or the control) at a step; ``mine``, ``skipped``
        and ``c_T_w`` the reference's."""
        ok, code, t_skipped, matches, inliers, pose = theirs
        self.steps += 1
        self.skips += not bool(ok)
        if (bool(ok) != mine.accept or int(code) != mine.code
                or int(t_skipped) != skipped):
            gap = STATE_GAP
        else:
            gap = float(np.abs(np.asarray(pose, np.float64)
                               - c_T_w.cpu().numpy()).max())
        self.pose_gap = max(self.pose_gap, gap)
        self.matches_gap = max(self.matches_gap,
                               abs(int(matches) - mine.matches))
        if mine.inliers is not None and inliers is not None:
            self.inliers_gap = max(self.inliers_gap,
                                   abs(int(inliers) - mine.inliers))

    def numbers(self) -> dict:
        return {"kp_mismatch": self.kp_bad / max(self.kp_all, 1),
                "matches_gap": self.matches_gap,
                "inliers_gap": self.inliers_gap,
                "pose_gap": self.pose_gap}


def checked_rows(rec, traffic: dict, seed: int) -> list:
    """The set-up rows, then ``check_steps`` window rows drawn from the
    seed (all of them where the window has fewer)."""
    setup = list(range(min(rec.setup_steps, len(rec.frame))))
    window = np.arange(rec.setup_steps, len(rec.frame))
    k = min(traffic["check_steps"], len(window))
    rng = np.random.default_rng([seed, 11])
    return setup + sorted(int(i) for i in rng.choice(window, size=k,
                                                     replace=False))


def readings(config: dict, traffic: dict, rec, lefts, rights, device,
             seed: int, control: bool | str = False, log=None) -> dict:
    """The numbers compared for one run's records. ``lefts`` are the
    (frames, 1, H, W) inputs the harness made (``rights`` are not read).
    ``control``: False (the program), True or ``"ransac"`` (the module's
    docstring)."""
    if control not in (False, True, "ransac"):
        raise ValueError(f"unknown control {control!r}")
    device = torch.device(device)
    p = ref.params(config)
    scale = float(traffic["trans_scale"])
    fx = Frames(lefts, ORB(**config["orb"]), device)
    fx_low = (Frames(lefts, ORB(**config["orb"], low=True), device)
              if control is True else fx if control else None)
    draws = ref.Draws(p.samples, device)
    follow = Follower(rec)
    rows = checked_rows(rec, traffic, seed)
    start = range(min(traffic["start_steps"], len(rec.frame)))
    need = {rec.frame[i] for i in list(start) + rows}
    need |= {follow.before(i)[0] for i in rows} - {None}
    need |= {follow.kept[i] for i in rec.feats} - {None}
    fx.prefetch(need)
    if fx_low not in (None, fx):
        fx_low.prefetch(need)
    t0 = time.perf_counter()
    tally = Tally()

    def theirs(i):
        return (rec.success[i][0], rec.code[i][0], rec.skipped[i],
                rec.matches[i][0], rec.inliers[i], rec.pose[i][0])

    def low_step(st, i):
        st, out = ref.step(st, fx_low.get(rec.frame[i]), draws.get(i),
                           scale, p, low=True)
        return st, (out.accept, out.code, st.skipped, out.matches,
                    out.inliers, st.c_T_w.cpu())

    # the start: the reference alone from the fresh state
    alone, low = ref.initial_state(device), ref.initial_state(device)
    for i in start:
        alone, mine = ref.step(alone, fx.get(rec.frame[i]), draws.get(i),
                               scale, p)
        if control:
            low, got = low_step(low, i)
        else:
            got = theirs(i)
        tally.step(got, mine, alone.skipped, alone.c_T_w)
    # the checked rows from the program's own state before each
    for i in rows:
        st, mine = ref.step(follow.state(i, fx, device), fx.get(rec.frame[i]),
                            draws.get(i), scale, p)
        if control:
            got = low_step(follow.state(i, fx_low, device), i)[1]
        else:
            got = theirs(i)
        tally.step(got, mine, st.skipped, st.c_T_w)
    # the features kept after the sampled units
    for i, kept in rec.feats.items():
        t = follow.kept[i]
        if t is not None:
            if control:
                low_t = fx_low.get(t)
                kept = (low_t.kp_xy, low_t.desc, low_t.kp_valid)
            tally.features(kept, fx.get(t))
    if log is not None:
        log(f"reference: {len(need)} frames extracted in {fx.seconds:.2f} s, "
            f"{tally.steps} steps compared ({len(start)} from the start, "
            f"{len(rows)} from the program's states; {tally.skips} of them "
            f"skips) in {time.perf_counter() - t0:.2f} s")
    return tally.numbers()

"""The comparison that decides ``correct`` for the stereo entries: what the
timed path produced, held against the plain reference
(``vobench/reference``) on the same inputs.

Every step of the run (set-up and window) is compared, for the cameras
drawn from the seed (``check_cameras`` of the mix; all of a single
camera). At each step the reference starts from the program's own state
before it, as the program's records give it (the accepted frames, ``c_T_w``
and the one before, the skip counter and code), with its own features of
those frames, and takes the step itself: the program's success flag, skip
code, pose and matches are held against its own. A frame's features, and
the match and fit of a pair of frames, depend on the frames alone, so the
reference extracts each frame shown once and fits each pair once. The
first ``start_steps`` steps it also runs alone from the fresh state,
composing its own poses, which checks the start and the carry. The
features the program kept for its last accepted frame after each sampled
unit (``Records.feats``) are held against the reference's of that frame.

Numbers compared, each held to its limit (``vobench/limits/<cell>.json``):

- ``disp_mismatch``: the share of compared pixels whose disparity or
  validity differs;
- ``kp_mismatch``: the share of keypoint slots whose validity, position
  or descriptor differs;
- ``matches_gap``: the widest gap in matches of a step (entries that report
  them);
- ``pose_gap``: the widest gap of an entry of ``c_T_w`` (m for the
  translation); a step whose success flag or skip code differs reads
  ``STATE_GAP``.

With ``control`` the reference in lower precision (``odometry`` module's
``low``) takes the program's place, from the same states.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vobench.reference import odometry as ref

STATE_GAP = 1.0   # m: a wrong success flag or skip code
REF_BATCH = 16    # frames the reference extracts at once


class Extractor:
    """The reference's features of (camera, frame), extracted in batches,
    each frame's valid keypoints counted, each pair's fit kept."""

    def __init__(self, cam, orb, odo, lefts, rights):
        self.cam, self.orb, self.odo = cam, orb, odo
        self.lefts, self.rights = lefts, rights
        self.cache, self.keypoints, self.fits = {}, {}, {}
        self.seconds = 0.0

    def prefetch(self, keys):
        t0 = time.perf_counter()
        todo = sorted(set(keys) - set(self.cache))
        for a in range(0, len(todo), REF_BATCH):
            part = todo[a:a + REF_BATCH]
            f = self.cam.extract(
                torch.stack([self.lefts[t, c] for c, t in part]),
                torch.stack([self.rights[t, c] for c, t in part]),
                self.orb, self.odo)
            counts = f.kp_valid.sum(-1).tolist()
            for j, key in enumerate(part):
                self.cache[key] = ref.Features(*(x[j] for x in f))
                self.keypoints[id(self.cache[key])] = int(counts[j])
        self.seconds += time.perf_counter() - t0

    def get(self, c, t) -> ref.Features:
        if (c, t) not in self.cache:
            self.prefetch([(c, t)])
        return self.cache[(c, t)]

    def fit(self, fa, fb):
        key = (id(fa), id(fb))
        if key not in self.fits:
            self.fits[key] = ref.fit(fa, fb, self.odo)
        return self.fits[key]

    def step(self, state, feats):
        return ref.step(state, feats, self.odo, self.fit,
                        self.keypoints[id(feats)])


class Follower:
    """The program's state of one camera before each step, from its
    records, with an extractor's features of its frames."""

    def __init__(self, rec, c):
        self.rec, self.c = rec, c
        self.acc = []       # rows the program accepted, in order
        self.skipped = 0
        self.i = 0

    def state(self, fx: Extractor) -> ref.State:
        """The state before row ``self.i``."""
        rec, c, i = self.rec, self.c, self.i
        if i == 0:
            return ref.initial_state()
        acc = self.acc
        c_T_w = torch.as_tensor(rec.pose[i - 1][c])
        c_T_w_prev = (torch.as_tensor(rec.pose[acc[-1] - 1][c])
                      if len(acc) >= 2 else
                      torch.eye(4, dtype=torch.float32))
        cur = fx.get(c, rec.frame[acc[-1]]) if acc else None
        prev = fx.get(c, rec.frame[acc[-2]]) if len(acc) >= 2 else None
        return ref.State(cur, prev, c_T_w, c_T_w_prev, self.skipped,
                         int(rec.code[i - 1][c]))

    def advance(self) -> None:
        """Take the program's row ``self.i`` into the state."""
        if self.rec.success[self.i][self.c]:
            if self.acc:
                self.skipped = 0
            self.acc.append(self.i)
        else:
            self.skipped += 1
        self.i += 1

    def kept(self):
        """The frame of the program's last accepted row, or None."""
        return self.rec.frame[self.acc[-1]] if self.acc else None


@dataclasses.dataclass
class Tally:
    disp_bad: int = 0
    disp_all: int = 0
    kp_bad: int = 0
    kp_all: int = 0
    matches_gap: int = 0
    pose_gap: float = 0.0
    steps: int = 0
    skips: int = 0

    def features(self, prog, mine: ref.Features):
        disp, kp_xy, desc, kp_valid = prog
        self.disp_bad += int((disp.to(mine.disp.device) != mine.disp).sum())
        self.disp_all += mine.disp.numel()
        v = kp_valid.to(mine.kp_valid.device)
        bad = (v != mine.kp_valid) | (v & (
            (kp_xy.to(mine.kp_xy.device) != mine.kp_xy).any(-1)
            | (desc.to(mine.desc.device) != mine.desc).any(-1)))
        self.kp_bad += int(bad.sum())
        self.kp_all += bad.numel()

    def step(self, ok, code, pose, matches, st: ref.State, ok_ref, n_ref):
        self.steps += 1
        self.skips += not bool(ok)
        if bool(ok) != bool(ok_ref) or int(code) != st.skip_code:
            gap = STATE_GAP
        else:
            gap = float(np.abs(np.asarray(pose, np.float64)
                               - st.c_T_w.numpy()).max())
        self.pose_gap = max(self.pose_gap, gap)
        if matches is not None:
            self.matches_gap = max(self.matches_gap,
                                   abs(int(matches) - int(n_ref)))

    def numbers(self, has_matches: bool) -> dict:
        out = {"disp_mismatch": self.disp_bad / max(self.disp_all, 1),
               "kp_mismatch": self.kp_bad / max(self.kp_all, 1)}
        if has_matches:
            out["matches_gap"] = self.matches_gap
        out["pose_gap"] = self.pose_gap
        return out


def checked_cameras(traffic: dict, cams: int, seed: int) -> list:
    """The cameras whose every step is compared: ``check_cameras`` of the
    mix (all where it is absent or larger), drawn from the seed."""
    k = min(traffic.get("check_cameras", cams), cams)
    rng = np.random.default_rng([seed, 7])
    return sorted(int(c) for c in rng.choice(cams, size=k, replace=False))


def readings(config: dict, traffic: dict, rec, lefts, rights, device,
             seed: int, control: bool = False, log=None) -> dict:
    """The numbers compared for one run's records. ``lefts`` and
    ``rights`` are the (frames, cameras, H, W) inputs the harness made."""
    sgbm, orb, odo = ref.params(config)
    cam = ref.Camera(config["camera"], sgbm, device)
    fx = Extractor(cam, orb, odo, lefts, rights)
    fx_low = (Extractor(cam, dataclasses.replace(orb, low=True), odo, lefts,
                        rights) if control else None)
    n_cams = len(rec.success[0])
    cams = checked_cameras(traffic, n_cams, seed)
    keys = sorted({(c, t) for c in cams for t in rec.frame})
    for x in (fx, fx_low):
        if x is not None:
            x.prefetch(keys)
    t0 = time.perf_counter()
    tally = Tally()
    rows = len(rec.frame)
    has_matches = rec.matches is not None
    for c in cams:
        def theirs(i):
            m = rec.matches[i][c] if has_matches else None
            return rec.success[i][c], rec.code[i][c], rec.pose[i][c], m

        # the start: the reference alone from the fresh state
        alone, low = ref.initial_state(), ref.initial_state()
        for i in range(min(traffic["start_steps"], rows)):
            alone, ok_ref, n_ref = fx.step(alone, fx.get(c, rec.frame[i]))
            if control:
                low, ok, m = fx_low.step(low, fx_low.get(c, rec.frame[i]))
                tally.step(ok, low.skip_code, low.c_T_w.numpy(),
                           m if has_matches else None, alone, ok_ref, n_ref)
            else:
                tally.step(*theirs(i), alone, ok_ref, n_ref)
        # every step from the program's own state before it
        follow = Follower(rec, c)
        for i in range(rows):
            feats = fx.get(c, rec.frame[i])
            mine, ok_ref, n_ref = fx.step(follow.state(fx), feats)
            if control:
                low, ok, m = fx_low.step(follow.state(fx_low),
                                         fx_low.get(c, rec.frame[i]))
                tally.step(ok, low.skip_code, low.c_T_w.numpy(),
                           m if has_matches else None, mine, ok_ref, n_ref)
            else:
                tally.step(*theirs(i), mine, ok_ref, n_ref)
            follow.advance()
            kept = rec.feats.get(i)
            if kept is not None and follow.kept() is not None:
                t = follow.kept()
                prog = (fx_low.get(c, t)[1:] if control else
                        tuple(x[c] if n_cams > 1 else x for x in kept))
                tally.features(prog, fx.get(c, t))
    if log is not None:
        log(f"reference: {len(keys)} frames extracted in {fx.seconds:.2f} s, "
            f"{len(fx.fits)} pairs fitted, {tally.steps} steps compared "
            f"(cameras {cams}, {tally.skips} of them skips) in "
            f"{time.perf_counter() - t0:.2f} s")
    return tally.numbers(has_matches)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number without a limit fails."""
    table = {k: {"value": v, "limit": limits.get(k)}
             for k, v in numbers.items()}
    ok = all(e["limit"] is not None and e["value"] <= e["limit"]
             for e in table.values())
    return ok, table

"""Entry points of the port, the counterpart of the repo's
``__graft_entry__.py``: the full stereo step at a small size, and a dry run
of the frame-sharded trajectory on several ranks.

    python3 -m openvo_tpu_torch.entry     # one step on the card

Both run on the card unless the caller passes ``device="cpu"``, and raise
where no card is present.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

from openvo_tpu_torch.ops._dispatch import target_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_setup(device, img_size=(320, 240), num_disp=64, nfeat=256,
                 kps=256, nlevels=8, f=280.0, baseline=0.5, n_frames=2,
                 step=0.2, band=(4.0, 100.0)):
    """(camera, config, lefts, rights): a rendered corridor and an odometer
    configuration at ``__graft_entry__._small_setup``'s sizes; the frames
    are uint8 numpy arrays."""
    from openvo_tpu_torch import OdometerConfig, ORBParams, StereoCamera
    from openvo_tpu_torch.config import SGBMParams
    from openvo_tpu_torch.io.synthetic import render_stereo_sequence

    seq = render_stereo_sequence(n_frames=n_frames, img_size=img_size, f=f,
                                 baseline=baseline, seed=0, step=step)
    sgbm = SGBMParams(num_disparities=num_disp, block_size=5, p1=200, p2=800,
                      disp12_max_diff=1, pre_filter_cap=63,
                      uniqueness_ratio=10)
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, sgbm, img_size,
                       device=device)
    cfg = OdometerConfig(
        nfeatures=nfeat,
        orb=ORBParams(nfeatures=nfeat, max_keypoints=kps, nlevels=nlevels),
        min_valid_disparity=band[0],
        max_valid_disparity=band[1],
    )
    lefts = np.clip(seq["left"], 0, 255).astype(np.uint8)
    rights = np.clip(seq["right"], 0, 255).astype(np.uint8)
    return cam, cfg, lefts, rights


def entry(device="cuda"):
    """(fn, example_args): the full stereo-odometer update (rectify -> SGBM
    -> reproject -> ORB -> match -> Kabsch -> gates -> pose chain) and the
    state and first pair to call it with, on ``device``."""
    import torch

    from openvo_tpu_torch.models.stereo_odometer import init_state, make_step

    cam, cfg, lefts, rights = _small_setup(device)
    step = make_step(cam, cfg, color=False)
    state = init_state(cam.cropped_shape, cfg.orb.max_keypoints, cam.device)
    return step, (state, torch.as_tensor(lefts[0], device=cam.device),
                  torch.as_tensor(rights[0], device=cam.device))


def dryrun_multichip(n_ranks: int, device="cuda") -> None:
    """Run the frame-sharded trajectory (``parallel/sharding.py``) once on
    ``n_ranks`` gloo ranks, each a process of its own that imports only
    torch and the port (a ``file://`` rendezvous in a temporary
    directory), 2 frames a rank at 192x144: frames extracted batched per
    rank, the block-boundary frame passed to the next rank, relative poses
    all-gathered and composed. Each rank checks the shapes and that at
    least 2n - 2 of the 2n frames are tracked; raises if any rank fails.
    On the card the ranks share it, their messages staged through host
    memory."""
    target_device(device)   # raise here, not in n children
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        code = ("import sys; from openvo_tpu_torch.entry import _dryrun_rank;"
                " _dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), "
                "sys.argv[3], sys.argv[4])")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(n_ranks), tmp,
             str(device)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(n_ranks)]
        failed = []
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            sys.stdout.write(out)
            if p.returncode != 0:
                failed.append(f"rank {r} (rc={p.returncode}):\n{err[-3000:]}")
    if failed:
        raise RuntimeError("dryrun_multichip failed:\n" + "\n".join(failed))


def _dryrun_rank(rank: int, n_ranks: int, tmp: str, device: str) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import torch
    import torch.distributed as dist

    from openvo_tpu_torch.parallel.sharding import make_sharded_trajectory_fn

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=n_ranks)
    try:
        # __graft_entry__.py's dry-run scene: 2 frames a rank
        n_frames = 2 * n_ranks
        cam, cfg, lefts, rights = _small_setup(
            device, img_size=(192, 144), num_disp=64, nfeat=192, kps=192,
            nlevels=4, f=210.0, baseline=0.5, n_frames=n_frames, step=0.2)
        traj, ok = make_sharded_trajectory_fn(cam, cfg)(lefts, rights)
        assert traj.shape == (n_frames, 4, 4), traj.shape
        assert ok.shape == (n_frames,), ok.shape
        n_ok = int(ok.sum())
        if rank == 0:
            print(f"dryrun_multichip({n_ranks}): trajectory "
                  f"{tuple(traj.shape)} ok {n_ok}/{n_frames}", flush=True)
        assert n_ok >= n_frames - 2, (
            f"sharded tracking failed: only {n_ok}/{n_frames} frames tracked")
        assert bool(torch.isfinite(traj).all()), "non-finite trajectory"
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    fn, args = entry()
    _, ok, _ = fn(*args)
    print(f"entry() ran one step on {args[1].device}: ok {bool(ok)}")

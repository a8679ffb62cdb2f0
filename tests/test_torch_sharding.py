"""The port's frame sharding (``openvo_tpu_torch/parallel/sharding.py``) and
entry points (``openvo_tpu_torch/entry.py``) against the JAX package:

- ``compose_trajectory`` against JAX's on 7 random transforms;
- ``make_relative_pose_fn`` against JAX's on 4 frames at 256x192, D=64
  (oks equal, relative poses within POSE_ATOL);
- the sharded function on 4 gloo ranks on the CPU, each a process of its
  own (a ``file://`` rendezvous in a temporary directory) that imports only
  torch and the port, against the port's one-process functions (flags
  equal, trajectory within 1e-5) and JAX's ``make_relative_pose_fn`` +
  ``compose_trajectory`` (within POSE_ATOL);
- ``entry(device="cpu")`` runs a step, ``entry()`` raises without a card,
  and ``dryrun_multichip(2, device="cpu")`` passes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvo_tpu
import openvo_tpu_torch
from openvo_tpu.config import OdometerConfig as JaxOdometerConfig
from openvo_tpu.config import ORBParams as JaxORBParams
from openvo_tpu.config import SGBMParams as JaxSGBMParams
from openvo_tpu.io.synthetic import render_stereo_sequence
from openvo_tpu.parallel import sharding as jsharding
from openvo_tpu_torch import entry
from openvo_tpu_torch.config import OdometerConfig, ORBParams, SGBMParams
from openvo_tpu_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_SIZE = (256, 192)
SGBM = dict(num_disparities=64, block_size=5, p1=200, p2=800,
            disp12_max_diff=1, pre_filter_cap=63, uniqueness_ratio=10)
RANKS = 4
N = 2 * RANKS
POSE_ATOL = 1e-4
SELF_ATOL = 1e-5


def test_compose_trajectory_matches_jax():
    """The random transforms of tests/test_parallel.py:38-53."""
    import cv2

    rng = np.random.default_rng(0)
    Ts = []
    for _ in range(7):
        R, _ = cv2.Rodrigues(rng.normal(scale=0.05, size=3))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = rng.normal(scale=0.1, size=3)
        Ts.append(T)
    Ts = np.stack(Ts).astype(np.float32)
    want = np.asarray(jsharding.compose_trajectory(jnp.asarray(Ts)))
    got = sharding.compose_trajectory(torch.from_numpy(Ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    acc = np.eye(4, dtype=np.float32)
    for i in range(7):
        acc = Ts[i] @ acc
        np.testing.assert_allclose(got[i], acc, rtol=0, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module, so that its many small CPU ops
    leave the cores to the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    s = render_stereo_sequence(n_frames=N, img_size=IMG_SIZE, f=280.0,
                               baseline=0.5, seed=0, step=0.3,
                               yaw_rate=0.004)
    return {**s, "left": np.clip(s["left"], 0, 255).astype(np.uint8),
            "right": np.clip(s["right"], 0, 255).astype(np.uint8)}


def cameras(seq):
    args = (seq["K"], seq["dist"], seq["K"], seq["dist"],
            {"R": seq["R"], "T": seq["T"]})
    jcam = openvo_tpu.StereoCamera(*args, JaxSGBMParams(**SGBM), IMG_SIZE)
    tcam = openvo_tpu_torch.StereoCamera(*args, SGBMParams(**SGBM), IMG_SIZE,
                                         device="cpu")
    jcfg = JaxOdometerConfig(nfeatures=256, orb=JaxORBParams(
        nfeatures=256, max_keypoints=256))
    tcfg = OdometerConfig(nfeatures=256, orb=ORBParams(nfeatures=256,
                                                       max_keypoints=256))
    return jcam, jcfg, tcam, tcfg


@pytest.fixture(scope="module")
def relative(seq):
    """JAX's and the port's one-process (T_rel, ok) over the N frames."""
    jcam, jcfg, tcam, tcfg = cameras(seq)
    Tj, okj = jax.jit(jsharding.make_relative_pose_fn(jcam, jcfg))(
        jnp.asarray(seq["left"]), jnp.asarray(seq["right"]))
    Tt, okt = sharding.make_relative_pose_fn(tcam, tcfg)(seq["left"],
                                                         seq["right"])
    return (np.asarray(Tj), np.asarray(okj)), (Tt, okt)


def test_relative_poses_match_jax_on_4_frames(seq):
    jcam, jcfg, tcam, tcfg = cameras(seq)
    Tj, okj = jax.jit(jsharding.make_relative_pose_fn(jcam, jcfg))(
        jnp.asarray(seq["left"][:4]), jnp.asarray(seq["right"][:4]))
    Tt, okt = sharding.make_relative_pose_fn(tcam, tcfg)(seq["left"][:4],
                                                         seq["right"][:4])
    assert Tt.shape == (4, 4, 4) and okt.shape == (4,)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0,
                               atol=POSE_ATOL)
    assert okt[0] and okt[1:].sum() >= 2
    np.testing.assert_array_equal(Tt[0].numpy(), np.eye(4))


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from openvo_tpu_torch import StereoCamera
from openvo_tpu_torch.config import OdometerConfig, ORBParams, SGBMParams
from openvo_tpu_torch.parallel.sharding import make_sharded_trajectory_fn

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                        rank=rank, world_size=n)
d = np.load(f"{tmp}/inputs.npz")
cam = StereoCamera(d["K"], d["dist"], d["K"], d["dist"],
                   {"R": d["R"], "T": d["T"]},
                   SGBMParams(num_disparities=64, block_size=5, p1=200,
                              p2=800, disp12_max_diff=1, pre_filter_cap=63,
                              uniqueness_ratio=10), (256, 192), device="cpu")
cfg = OdometerConfig(nfeatures=256, orb=ORBParams(nfeatures=256,
                                                  max_keypoints=256))
traj, ok = make_sharded_trajectory_fn(cam, cfg)(d["left"], d["right"])
np.savez(f"{tmp}/rank{rank}.npz", traj=traj.numpy(), ok=ok.numpy())
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def sharded(seq, tmp_path_factory):
    """Each rank's (trajectory, flags) from the sharded function on RANKS
    gloo ranks on the CPU."""
    tmp = tmp_path_factory.mktemp("sharded")
    np.savez(tmp / "inputs.npz", **{k: seq[k] for k in
                                    ("left", "right", "K", "dist", "R",
                                     "T")})
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(RANKS), str(tmp)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(RANKS)]
    errors = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        if p.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]


def test_sharded_equals_one_process_and_jax(sharded, relative):
    (Tj, okj), (Tt, okt) = relative
    one = sharding.compose_trajectory(Tt).numpy()
    want = np.asarray(jsharding.compose_trajectory(jnp.asarray(Tj)))
    for r, out in enumerate(sharded):
        assert out["traj"].shape == (N, 4, 4) and out["ok"].shape == (N,)
        np.testing.assert_array_equal(out["ok"], okt.numpy(),
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(out["traj"], one, rtol=0, atol=SELF_ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["ok"], okj, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["traj"], want, rtol=0,
                                   atol=POSE_ATOL, err_msg=f"rank {r}")
    assert okt.sum() >= N - 2


def test_sharded_rejects_an_indivisible_frame_count(monkeypatch, seq):
    def three_ranks(self, group, device):
        self.group, self.n, self.rank, self.device = group, 3, 0, device
        self.stage = False

    monkeypatch.setattr(sharding._Transport, "__init__", three_ranks)
    _, _, tcam, tcfg = cameras(seq)
    fn = sharding.make_sharded_trajectory_fn(tcam, tcfg)
    with pytest.raises(ValueError, match="divisible"):
        fn(seq["left"], seq["right"])


def test_entry_runs_one_step_on_the_cpu():
    step, (state, left, right) = entry.entry(device="cpu")
    assert left.device.type == "cpu" and left.shape == (240, 320)
    state, ok, stats = step(state, left, right)
    assert bool(ok) and bool(state.has_cur)
    assert int(stats["n_kps"]) >= 10


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_on_two_cpu_ranks(capfd):
    entry.dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2): trajectory (4, 4, 4) ok" in capfd.readouterr(
    ).out

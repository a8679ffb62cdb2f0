"""The port's row-tiled SGBM (``openvo_tpu_torch/parallel/tiling.py``)
against the JAX package's single-device ``sgbm_disparity16``, and the two
kernel variants only it runs: the scan carry in and out (K2's
``init_carry``/``return_carry``) and the cost of a row band with halo rows
(K1's ``band_halo``), as plain versions against the JAX package.

The tiled function runs on 4 gloo ranks on the CPU, each a process of its
own (a ``file://`` rendezvous in a temporary directory) that imports only
torch and the port; the JAX references are computed here. The JAX package
holds its own tiled function to the same single-device function
(tests/test_tiling.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openvo_tpu.ops import sgbm as jsgbm
from openvo_tpu_torch.ops import sgbm, sgbm_cuda
from test_torch_sgbm_configs import (corridor_pair, jax_disp16, params_kw,
                                     prefiltered, textured_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4


def corridor_u8(img_size=(256, 96)):
    from openvo_tpu.io.synthetic import render_stereo_sequence

    seq = render_stereo_sequence(n_frames=1, img_size=img_size, f=220.0,
                                 baseline=0.4, seed=0)
    return tuple(np.clip(seq[k][0], 0, 255).astype(np.uint8)
                 for k in ("left", "right"))


# ---------------------------------------------------------------------------
# the scan carry
# ---------------------------------------------------------------------------


def _grid_costs(grid):
    """(JAX cost, port cost, p1, p2 on the port's grid, x2 factor): int16 x2
    at block 5, float32 x1 at block 13 on a fractional pair."""
    left, right = textured_pair(40, 96, shift=7.37, seed=2,
                                integer=grid == "int16")
    block = 5 if grid == "int16" else 13
    lj, rj, lt, rt = prefiltered(left, right, 63)
    Cj = jsgbm.block_sum(jsgbm.bt_cost_volume(lj, rj, 0, 32, block_size=block,
                                              cap=63), block)
    p1, p2 = 8 * block * block, 32 * block * block
    if grid == "int16":
        C, _ = sgbm_cuda.cost_hsweep(lt, rt, 0, 32, block,
                                     sgbm.int16_sentinel(block, 63), 2 * p1,
                                     2 * p2, True)
        return Cj, C, 2 * p1, 2 * p2, 2
    return Cj, sgbm_cuda.cost_volume_f32(lt, rt, 0, 32, block, 63, True), \
        p1, p2, 1


@pytest.mark.parametrize("grid", ["int16", "float32"])
@pytest.mark.parametrize("xshift", [0, 1, -1])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_carry_equals_jax(grid, xshift, reverse):
    """``sgm_scan`` (x2) and ``scan_f32`` (x1) with ``init`` and
    ``return_carry`` continue a scan as ``_scan_dirs(..., init=...,
    return_carry=True)`` does: L and carry equal JAX's (twice JAX's on the
    x2 grid)."""
    Cj, C, p1, p2, k = _grid_costs(grid)
    split = 17
    first, second = (slice(split, None), slice(None, split)) if reverse \
        else (slice(None, split), slice(split, None))
    jp1, jp2 = float(p1 // k), float(p2 // k)
    _, cj = jsgbm._scan_dirs(Cj[first], (xshift,), jp1, jp2, reverse,
                             return_carry=True)
    Sj, cj2 = jsgbm._scan_dirs(Cj[second], (xshift,), jp1, jp2, reverse,
                               init=cj, return_carry=True)
    scan = sgbm_cuda.sgm_scan if grid == "int16" else sgbm_cuda.scan_f32
    init = torch.from_numpy(np.asarray(cj[0]) * k)
    if grid == "int16":
        init = init.to(torch.int32)
    L, carry = scan(C[second], xshift, p1, p2, reverse, init=init,
                    return_carry=True)
    np.testing.assert_array_equal(L.numpy(), k * np.asarray(Sj))
    np.testing.assert_array_equal(carry.numpy(), k * np.asarray(cj2[0]))


@pytest.mark.parametrize("grid", ["int16", "float32"])
@pytest.mark.parametrize("diagonals,reverse", [
    (False, False), (False, True), (True, False), (True, True)])
def test_vsweep_carry_handoff_equals_unsplit(grid, diagonals, reverse):
    """A volume split at a row, the carry of the first part handed to the
    second, gives the unsplit sweep: down, up, the straight line and the
    trio (the JAX package's ``test_sweep_v_carry_handoff_on_tpu``)."""
    _, C, p1, p2, _ = _grid_costs(grid)
    ways = dict(down=not reverse, up=reverse)
    whole = sgbm_cuda.vsweep(C, p1, p2, diagonals, **ways)
    split = 23
    first, second = (C[split:], C[:split]) if reverse else (C[:split],
                                                             C[split:])
    a, carry = sgbm_cuda.vsweep(first, p1, p2, diagonals, **ways,
                                return_carry=True)
    b = sgbm_cuda.vsweep(second, p1, p2, diagonals, **ways,
                         init_carry=carry)
    assert carry.shape == (3 if diagonals else 1,) + tuple(C.shape[1:])
    joined = torch.cat([b, a]) if reverse else torch.cat([a, b])
    assert torch.equal(joined, whole)


# ---------------------------------------------------------------------------
# the band
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", ["int16", "float32"])
@pytest.mark.parametrize("where", ["top", "interior", "bottom"])
def test_band_cost_equals_rows_of_the_frame(grid, where):
    """The cost of a row band cut from a frame, with its halo rows (the
    image's border row replicated at its edges, as the tiled path builds
    it), equals the band's rows of the whole frame's cost volume: K1's
    ``band_halo`` (H1's plain version over int16, ``cost_volume_f32``
    over float32)."""
    left, right = textured_pair(48, 96, shift=7.37, seed=4,
                                integer=grid == "int16")
    block = 5 if grid == "int16" else 13
    halo, h_t = block // 2 + 1, 12
    r0 = {"top": 0, "interior": 18, "bottom": 48 - h_t}[where]
    rows = np.clip(np.arange(r0 - halo, r0 + h_t + halo), 0, 47)
    band = (halo, where == "top", where == "bottom")

    def cost(l_img, r_img, band_):
        lt = sgbm.prefilter_xsobel(torch.from_numpy(l_img), 63)
        rt = sgbm.prefilter_xsobel(torch.from_numpy(r_img), 63)
        if grid == "int16":
            return sgbm_cuda.cost_hsweep(lt, rt, 0, 32, block,
                                         sgbm.int16_sentinel(block, 63), 400,
                                         1600, True, band_)
        return (sgbm_cuda.cost_volume_f32(lt, rt, 0, 32, block, 63, True,
                                          band_),)

    whole = cost(left, right, None)
    part = cost(left[rows], right[rows], band)
    for w, p in zip(whole, part):
        assert torch.equal(p, w[r0:r0 + h_t])


# ---------------------------------------------------------------------------
# the tiled path on 4 gloo ranks
# ---------------------------------------------------------------------------

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from openvo_tpu_torch.config import SGBMParams
from openvo_tpu_torch.parallel.tiling import make_tiled_sgbm_fn

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                        rank=rank, world_size=n)
data = np.load(f"{tmp}/inputs.npz")
out = {}
for name, kw in json.loads(str(data["configs"])).items():
    fn = make_tiled_sgbm_fn(SGBMParams(**kw), device="cpu")
    out[name] = fn(data[name + "_left"], data[name + "_right"]).numpy()
try:
    fn(np.zeros((97, 128), np.uint8), np.zeros((97, 128), np.uint8))
except ValueError as e:
    out["h97"] = np.array(str(e))
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.destroy_process_group()
"""

OFF_LAT = params_kw(D=32)   # the bench's off-lat parameters at D=32
TILED = {
    "5paths": (OFF_LAT, "integer"),
    "8paths": (dict(OFF_LAT, num_paths=8), "integer"),
    "4paths": (dict(OFF_LAT, num_paths=4), "integer"),
    "speckle": (dict(OFF_LAT, speckle_window_size=50, speckle_range=2),
                "integer"),
    "block13": (params_kw(D=32, block=13, p1=8 * 169, p2=32 * 169),
                "fractional"),
}


def tiled_pair(kind):
    if kind == "integer":
        return corridor_u8()
    return corridor_pair(img_size=(256, 96))


@pytest.fixture(scope="module")
def tiled(tmp_path_factory):
    """Each configuration's disparity from the port's tiled function on 4
    gloo ranks on the CPU: the ranks' bands stacked in rank order."""
    tmp = tmp_path_factory.mktemp("tiled")
    arrays = {"configs": np.array(json.dumps(
        {name: kw for name, (kw, _) in TILED.items()}))}
    for name, (_, kind) in TILED.items():
        arrays[name + "_left"], arrays[name + "_right"] = tiled_pair(kind)
    np.savez(tmp / "inputs.npz", **arrays)
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
    bands = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]
    return {k: (np.concatenate([b[k] for b in bands]) if k != "h97"
                else [str(b[k]) for b in bands]) for k in bands[0]}


@pytest.mark.parametrize("name", list(TILED))
def test_tiled_equals_jax_single_device(tiled, name):
    """The ranks' bands, in rank order, are JAX's single-device disp16 bit
    for bit: 5 paths (the bench's off-lat parameters), 8 and 4 paths, the
    speckle filter, and blockSize 13 (no int16 sentinel, float32) on the
    fractional pair."""
    kw, kind = TILED[name]
    left, right = tiled_pair(kind)
    ref = jax_disp16(left, right, kw)
    assert tiled[name].dtype == np.int16
    np.testing.assert_array_equal(tiled[name], ref)
    assert (ref > -16).mean() > 0.3


def test_tiled_indivisible_height_raises(tiled):
    """H = 97 on 4 ranks raises a ValueError that says why, on every rank."""
    assert len(tiled["h97"]) == RANKS
    assert all("divisible" in msg for msg in tiled["h97"])


def test_tiled_rejects_a_band_shorter_than_its_halo(monkeypatch):
    """A tile shorter than its halo cannot take its neighbours' rows: 16
    ranks of 6 rows at blockSize 13 (a 7-row halo)."""
    from openvo_tpu_torch.config import SGBMParams
    from openvo_tpu_torch.parallel import tiling

    def first_of_16(self, group, device):
        self.group, self.n, self.rank, self.device = group, 16, 0, device

    monkeypatch.setattr(tiling._Transport, "__init__", first_of_16)
    fn = tiling.make_tiled_sgbm_fn(SGBMParams(block_size=13), device="cpu")
    with pytest.raises(ValueError, match="halo"):
        fn(np.zeros((96, 64), np.uint8), np.zeros((96, 64), np.uint8))

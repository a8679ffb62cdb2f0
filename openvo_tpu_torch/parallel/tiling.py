"""Row-tiled SGBM across the ranks of a ``torch.distributed`` group: PyTorch
port of ``openvo_tpu/parallel/tiling.py``. The process group takes the place
of the JAX device mesh and ``dist.get_rank(group)`` that of ``axis_index``:
JAX's ``make_row_mesh`` (``tiling.py:52``) has no counterpart, because a
caller passes :func:`make_tiled_sgbm_fn` a group (the default group if
None), set up by ``torch.distributed.init_process_group`` or ``new_group``.

Decomposition (exact, not an approximation), as in the JAX package:

- Rank r holds rows [r*H/n, (r+1)*H/n) of the stereo pair. The cost volume
  needs a (block radius + 1)-row halo (1 row for the x-Sobel prefilter +
  the radius of the box sum): the neighbours' boundary rows come in by one
  ``all_gather`` of every rank's edge rows; the image's top and bottom
  edges replicate their own border row (:func:`_exchange_halo`). H1 then
  builds the cost of the core rows from the band, replicating the first /
  last core row's cost at the image's edges, as the single-device box sum
  does (K1's ``band_halo``).
- The horizontal scans and the WTA, uniqueness, subpixel and left-right
  steps are row-local: H1 (or H5 without an int16 sentinel) and H3 run on
  each rank's rows in parallel.
- The vertical scans run as a wavefront (:func:`_vertical_wavefront`): in
  n steps, each rank continues the sweep from the carry (the last row's L
  of every direction) that the rank above (below, bottom-up) hands it, and
  hands its own on (H2 with K2's ``init_carry``/``return_carry``). Serial
  work equals one whole-image sweep.
- The speckle filter is a global connected-component pass over the (H, W)
  disparity: every rank gathers the bands, runs it, and keeps its own rows.

Messages go through the group's backend. Where the backend is gloo and the
tensors lie on a CUDA card, each message is copied to the host for the call
and back after it: that is how several ranks share one card (NCCL refuses
two ranks on one GPU). Only the messages move; every kernel runs on the
card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from openvo_tpu_torch.config import SGBMParams
from openvo_tpu_torch.ops import sgbm, sgbm_cuda
from openvo_tpu_torch.ops._dispatch import target_device


class _Transport:
    """Point-to-point and all-gather messages of one process group, staged
    through host memory where gloo carries tensors that lie on a card."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = device
        self.stage = (device.type == "cuda"
                      and dist.get_backend(group) == "gloo")

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _wire(self, t):
        return t.cpu() if self.stage else t.contiguous()

    def all_gather(self, t):
        """(n, *t.shape): every rank's ``t``, in rank order."""
        t = self._wire(t)
        out = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out).to(self.device)

    def send(self, t, r: int, tag: int) -> None:
        dist.send(self._wire(t), self._peer(r), group=self.group, tag=tag)

    def recv(self, shape, dtype, r: int, tag: int):
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self.stage else self.device)
        dist.recv(buf, self._peer(r), group=self.group, tag=tag)
        return buf.to(self.device)


def _exchange_halo(pair, comm: _Transport, halo: int):
    """Extend a (2, h_t, W) left/right band with ``halo`` rows from each
    vertical neighbour; the image's top and bottom edges replicate their
    border row, as the single-device edge pad does."""
    # every[k] = rank k's (top rows, bottom rows)
    every = comm.all_gather(torch.stack([pair[:, :halo], pair[:, -halo:]]))
    r = comm.rank
    above = (pair[:, :1].expand(-1, halo, -1) if r == 0 else every[r - 1, 1])
    below = (pair[:, -1:].expand(-1, halo, -1) if r == comm.n - 1
             else every[r + 1, 0])
    return torch.cat([above, pair, below], dim=1)


def _vertical_wavefront(C, p1: int, p2: int, diagonals: bool, reverse: bool,
                        comm: _Transport, acc=None):
    """This rank's part of a top-down (bottom-up if ``reverse``) sweep of
    the vertical directions across the row tiles. The sweep has n steps in
    rank order (reversed bottom-up); at its step a rank starts from the
    (ndirs, W, D) carry the previous rank hands it (none at step 0, which
    starts fresh as the single-device sweep does) and hands its own carry to
    the next. ``acc`` as ``sgbm_cuda.vsweep``'s."""
    n, r = comm.n, comm.rank
    step = n - 1 - r if reverse else r
    prev, nxt = (r + 1, r - 1) if reverse else (r - 1, r + 1)
    tag = int(reverse)
    init = None
    if step > 0:
        nd = 3 if diagonals else 1
        acc_t = torch.int32 if C.dtype == torch.int16 else torch.float32
        init = comm.recv((nd,) + tuple(C.shape[1:]), acc_t, prev, tag)
    hand_on = step < n - 1
    out = sgbm_cuda.vsweep(C, p1, p2, diagonals, down=not reverse,
                           up=reverse, init_carry=init, return_carry=hand_on,
                           acc=acc)
    if not hand_on:
        return out
    sv, carry = out
    comm.send(carry, nxt, tag)
    return sv


def make_tiled_sgbm_fn(params: SGBMParams, group=None, device="cuda"):
    """Build ``fn(left (H, W), right (H, W)) -> (H/n, W) int16`` disparity x16
    of this rank's rows, for every rank of ``group`` (the default group if
    None) to call with the same pair; the ranks' bands in rank order are
    the single-device ``sgbm_disparity16`` bit for bit. H must be a
    multiple of the group's size.

    Runs on ``device``, the current card unless the caller passes
    ``device="cpu"`` (raises where no card is present): CPU tensors take
    the kernels' plain versions, CUDA tensors the kernels."""
    dev = target_device(device)
    comm = _Transport(group, dev)
    n, rank = comm.n, comm.rank
    cap = max(params.pre_filter_cap, 15) | 1
    halo = params.block_size // 2 + 1   # prefilter stencil + box radius
    band = (halo, rank == 0, rank == n - 1)
    invalid = (params.min_disparity - 1) * 16
    speckle = params.speckle_window_size > 0 and params.speckle_range > 0

    def fn(left, right):
        H, W = left.shape
        if H % n:
            raise ValueError(f"row-tiled SGBM needs H divisible by the group "
                             f"size: H={H}, group of {n} ranks")
        h_t = H // n
        if h_t < halo:
            raise ValueError(f"row tiles of {h_t} rows are shorter than the "
                             f"{halo}-row halo")
        rows = slice(rank * h_t, (rank + 1) * h_t)
        pair = torch.stack([torch.as_tensor(left)[rows],
                            torch.as_tensor(right)[rows]]).to(dev,
                                                              torch.float32)
        ext = _exchange_halo(pair, comm, halo)
        lp = sgbm.prefilter_xsobel(ext[0], cap)
        rp = sgbm.prefilter_xsobel(ext[1], cap)
        C, s1, p1, p2 = sgbm.cost_and_forward(lp, rp, params, cap, band)
        diagonals = params.num_paths != 4
        svu = None
        if C.dtype == torch.int16:
            # exact in any order: both sweeps add into s1
            _vertical_wavefront(C, p1, p2, diagonals, False, comm, s1)
            if params.num_paths != 5:
                _vertical_wavefront(C, p1, p2, diagonals, True, comm, s1)
            sv = None
        else:
            sv = _vertical_wavefront(C, p1, p2, diagonals, False, comm)
            if params.num_paths != 5:
                svu = _vertical_wavefront(C, p1, p2, diagonals, True, comm)
        out = sgbm_cuda.hsweep_wta_lr(C, s1, sv, p1, p2, params.min_disparity,
                                      params.uniqueness_ratio,
                                      params.disp12_max_diff, svu)
        if speckle:
            # as int32: gloo carries no int16
            every = comm.all_gather(out.to(torch.int32)).reshape(H, W)
            keep = sgbm.speckle_filter(every, every != invalid, params)
            out = torch.where(keep[rows], out, invalid)
        return out

    return fn

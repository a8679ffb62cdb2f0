"""The five-point solver's root stage on the CPU: H12's wrapper
(``ops/fivepoint_cuda.five_point_roots``) refuses what the kernel cannot
take, the route in ``pose/fivepoint`` takes the plain version on the CPU,
and the plain scan and bisection on built z-matrices. The kernel itself is
held to the plain version on the card (``tests/test_torch_kernels.py -k
five_point``)."""

import numpy as np
import pytest
import torch

from openvo_tpu_torch.ops import fivepoint_cuda
from openvo_tpu_torch.pose import fivepoint
from openvo_tpu_torch.tools import svd_cases


def mono_system(seed=0, samples=16):
    """(M, basis) of seeded five-point rows, as the mono path makes them on
    the CPU."""
    rows = torch.from_numpy(svd_cases.five_point_rows(seed, samples)
                            .astype(np.float32))
    basis = fivepoint.basis_of_rows(rows)
    return fivepoint.eliminated_system(basis), basis


def built_system(kind, samples=8):
    B = svd_cases.z_matrices(kind, samples)
    rng = np.random.default_rng(1)
    return (torch.from_numpy(svd_cases.system_of_z_matrix(B)),
            torch.from_numpy(rng.normal(size=(samples, 4, 3, 3))
                             .astype(np.float32)))


def sign_changes(M):
    return fivepoint._scan(fivepoint._det_poly(fivepoint._z_matrix(M)))[2]


def test_wrapper_raises_on_cpu_tensors():
    M, basis = mono_system(samples=2)
    with pytest.raises(ValueError, match="CUDA"):
        fivepoint_cuda.five_point_roots(M.contiguous(), basis.contiguous())


@pytest.mark.parametrize("bad", ["M float64", "basis float64", "M 3 axes",
                                 "M 9x10", "basis (S, 3, 3, 3)",
                                 "basis of other S", "M not contiguous"])
def test_wrapper_raises_on_wrong_input(bad):
    M = torch.zeros((4, 10, 10))
    basis = torch.zeros((4, 4, 3, 3))
    args, err = {
        "M float64": ((M.double(), basis), TypeError),
        "basis float64": ((M, basis.double()), TypeError),
        "M 3 axes": ((M[0], basis), ValueError),
        "M 9x10": ((M[:, :9], basis), ValueError),
        "basis (S, 3, 3, 3)": ((M, basis[:, :3]), ValueError),
        "basis of other S": ((M, basis[:3]), ValueError),
        "M not contiguous": ((M.transpose(1, 2), basis), ValueError),
    }[bad]
    with pytest.raises(err):
        fivepoint_cuda.five_point_roots(*args)


def test_from_basis_on_the_cpu_equals_roots_plain():
    """``five_point_from_basis`` on CPU tensors is the elimination and
    ``five_point_roots_plain``, bit for bit, and launches nothing."""
    _, basis = mono_system(3, 16)
    n0 = fivepoint_cuda.five_point_roots.launches
    Es, valid = fivepoint.five_point_from_basis(basis)
    Ep, vp = fivepoint.five_point_roots_plain(
        fivepoint.eliminated_system(basis), basis)
    assert fivepoint_cuda.five_point_roots.launches == n0
    assert torch.equal(Es, Ep) and torch.equal(valid, vp)
    assert valid.any() and Es.shape == (16, 10, 3, 3)


@pytest.mark.parametrize("kind", ["no real root", "clustered roots"])
def test_built_z_matrices_come_back_from_their_system(kind):
    """``svd_cases.system_of_z_matrix`` gives the M whose z-matrix is B."""
    B = svd_cases.z_matrices(kind)
    M = torch.from_numpy(svd_cases.system_of_z_matrix(B))
    np.testing.assert_array_equal(fivepoint._z_matrix(M).numpy(), B)


def test_no_real_root_leaves_every_slot_invalid():
    """A determinant positive on the whole line: no cell changes sign, the
    ten slots take cells 0-9 and are all invalid."""
    M, basis = built_system("no real root")
    assert not sign_changes(M).any()
    Es, valid = fivepoint.five_point_roots(M, basis)
    assert not valid.any() and Es.shape == (8, 10, 3, 3)


def test_more_than_ten_sign_changes_keep_the_first_ten():
    """Clustered roots' flat zeros give the float32 scan more than ten sign
    changes in some samples; the solver keeps the first ten cells in
    ascending order: every slot valid, its roots ascending."""
    M, _ = built_system("clustered roots")
    counts = sign_changes(M).sum(-1)
    many = counts > 10
    assert many.any(), counts
    roots, valid = fivepoint._real_roots(
        fivepoint._det_poly(fivepoint._z_matrix(M)))
    assert valid[many].all()
    assert (roots[many][:, 1:] >= roots[many][:, :-1]).all()
    assert (valid.sum(-1) == counts.clamp_max(10)).all()


def test_tiny_null_vector_w_invalidates_its_slot():
    """Column 0 of B(z) scaled by 1e-20: the scan still finds its roots,
    but the picked null vector's |w| <= 1e-12 invalidates those slots."""
    M, basis = mono_system(4, 8)
    M[:4, 4:10, 0:3] *= 1e-20
    _, scan_valid = fivepoint._real_roots(
        fivepoint._det_poly(fivepoint._z_matrix(M)))
    _, valid = fivepoint.five_point_roots(M, basis)
    assert (valid <= scan_valid).all()
    assert int(scan_valid[:4].sum()) - int(valid[:4].sum()) >= 4


def test_singular_system_gives_invalid_slots():
    """A zero basis makes the 10x10 system singular: its M is not finite
    and none of its slots is valid."""
    _, basis = mono_system(3, 6)
    basis[2] = 0
    M = fivepoint.eliminated_system(basis)
    assert not torch.isfinite(M[2]).all()
    _, valid = fivepoint.five_point_roots(M, basis)
    assert not valid[2].any() and valid[[0, 1, 3, 4, 5]].any()

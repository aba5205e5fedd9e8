"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
elsewhere.  The file imports neither JAX nor the reference package, so it
also runs on a GPU machine without them:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the reference's Pallas-vs-oracle ones: kernel_matrix 2e-5,
kernel_matvec and cd_column_update 2e-4; plain f32 with TF32 off.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.kernels import Kernel
from repro_torch.kernels import ops, ref

KINDS = [dict(kind="rbf", gamma=4.0),
         dict(kind="poly", gamma=0.5, degree=3, coef0=1.0),
         dict(kind="linear")]


@pytest.fixture
def cuda_device():
    """The first GPU, with TF32 off for the plain versions; the test skips
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rkw(kern):
    return dict(kind=kern.kind, gamma=kern.gamma, degree=kern.degree,
                coef0=kern.coef0)


# (kernel, d): the reference's kernel sweeps run poly at d <= 17; at d = 54
# poly values reach (0.5 * 13.5 + 1)^3 ~ 465, and a matvec over them that
# cancels to near 0 is outside what a 2e-4 tolerance can hold in f32.
CASES = [(KINDS[0], 17), (KINDS[0], 54), (KINDS[1], 17), (KINDS[2], 17),
         (KINDS[2], 54)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,d", CASES,
                         ids=[f"{kw['kind']}-d{d}" for kw, d in CASES])
def test_cuda_kernels_match_plain_versions(cuda_device, kw, d):
    """Each kernel against its plain version at non-tile-aligned shapes."""
    rng = np.random.default_rng(0)
    kern = Kernel(**kw)
    X = torch.tensor(rng.uniform(size=(300, d)), dtype=torch.float32,
                     device=cuda_device)
    Z = X[:130].contiguous()
    v = torch.tensor(rng.standard_normal(130), dtype=torch.float32,
                     device=cuda_device)
    y = torch.sign(torch.tensor(rng.standard_normal(300),
                                dtype=torch.float32, device=cuda_device))
    torch.testing.assert_close(ops.kernel_matrix(X, Z, kern),
                               ref.kermat_ref(X, Z, **_rkw(kern)),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(ops.kernel_matvec(X, Z, v, kern),
                               ref.kernel_matvec_ref(X, Z, v, **_rkw(kern)),
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(
        ops.cd_column_update(X, y, Z[:64], v[:64], kern),
        ref.cd_column_update_ref(X, y, Z[:64], v[:64], **_rkw(kern)),
        rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_batched_kernels_match_plain_versions(cuda_device):
    """The batch dimension (grid y / z): every item against its plain
    version, and the block widths of cd_column_update up to B = 256."""
    rng = np.random.default_rng(1)
    kern = Kernel("rbf", gamma=1.0)
    X = torch.tensor(rng.uniform(size=(3, 257, 54)), dtype=torch.float32,
                     device=cuda_device)
    Z = torch.tensor(rng.uniform(size=(3, 1000, 54)), dtype=torch.float32,
                     device=cuda_device)
    v = torch.tensor(rng.standard_normal((3, 1000)), dtype=torch.float32,
                     device=cuda_device)
    torch.testing.assert_close(ops.kernel_matrix(X, Z, kern),
                               ref.kermat_ref(X, Z, **_rkw(kern)),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(ops.kernel_matvec(X, Z, v, kern),
                               ref.kernel_matvec_ref(X, Z, v, **_rkw(kern)),
                               rtol=2e-4, atol=2e-4)
    y = torch.sign(v[0])
    for B in (1, 64, 65, 200, 256):
        torch.testing.assert_close(
            ops.cd_column_update(Z[0], y, X[0, :B], v[1, :B], kern),
            ref.cd_column_update_ref(Z[0], y, X[0, :B], v[1, :B],
                                     **_rkw(kern)),
            rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()

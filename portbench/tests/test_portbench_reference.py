"""The plain reference: float64 products against dense numpy, and TF32 rounding."""
import numpy as np
import pytest
import torch

import pb_common  # noqa: F401
from reference.sparse import Coo, round_tf32


def _random_coo(m, n, nnz, seed):
    """Distinct coordinates, as the benchmark's matrices have."""
    rng = np.random.default_rng(seed)
    key = rng.choice(m * n, size=nnz, replace=False)
    return key // n, key % n, rng.standard_normal(nnz).astype(np.float32)


@pytest.mark.parametrize("block", [7, 1 << 25])
def test_coo_matches_a_dense_product(block):
    r, c, v = _random_coo(40, 30, 300, 1)
    A = np.zeros((40, 30))
    np.add.at(A, (r, c), v.astype(np.float64))
    x = torch.rand(30, dtype=torch.float32) * 2 - 1
    coo = Coo(r, c, v, (40, 30), "cpu", block=block)
    y = coo.matvec(x)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), A @ x.double().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(coo.matvec(x, absolute=True).numpy(),
                               np.abs(A) @ np.abs(x.double().numpy()), rtol=1e-12, atol=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0])
    y = round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0]
    z = torch.rand(10000) * 2 - 1
    rel = ((round_tf32(z) - z).abs() / z.abs().clamp_min(1e-30)).max()
    assert 2**-13 < rel <= 2**-11

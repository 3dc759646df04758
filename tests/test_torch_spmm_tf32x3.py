"""The tolerance argument of the SpMM kernel's tensor-core products, on the CPU.

For B > 32 ``csrc/cb_spmm.cu`` multiplies on the tensor cores in 3xTF32:
each float32 operand is rounded to TF32 (10 mantissa bits, round to
nearest, ties away from zero, as ``cvt.rna.tf32.f32`` does) into ``hi``,
its remainder rounded again into ``lo``, and every step of 8 reduction
columns adds ``lo*hi``, ``hi*lo`` and ``hi*hi`` into float32 accumulators,
c ascending. The CUDA kernel cannot run here, so this file emulates that
arithmetic in plain torch and holds it against float64:

- within ``KERNEL_TOL / 10`` (1e-5) of the largest value, at the edge
  grid's B and at the cb-paper MLP's reduction lengths (a 1024-term
  forward or dX output is eight 128-term slot partials summed in float32 by
  the combine; dW sums 4096 tokens), which leaves a factor of ten under the
  1e-4 that ``chip_smoke.py`` holds the kernel to;
- bit-exact on integer data in [-4, 4] (small integers are TF32, their lo
  halves are 0, the sums stay below 2^24);
- single-pass TF32 on the same data errs at least 30x more, which is why
  the kernel splits.

The emulated kernel also matches the JAX package's Pallas kernel (interpret
mode) on the same bytes. Nothing on the port's path calls the emulation.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

j_spmm = importlib.import_module("repro.kernels.cb_spmm")

KERNEL_TOL = 1e-4        # chip_smoke.py: kernel vs its plain version
MMA_K = 8                # reduction columns per mma.m16n8k8
CASES = [  # (name, reduction length, terms per slot partial)
    *[(f"edge-B{B}", B, B) for B in (8, 16, 24, 64, 100, 128)],
    ("mlp-forward-dX", 1024, 128),
    ("mlp-dW", 4096, 4096),
]
IDS = [c[0] for c in CASES]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, ties away from zero."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def slot_partial(a: torch.Tensor, x: torch.Tensor, passes: int) -> torch.Tensor:
    """(M, K) @ (K, N) as one kernel slot computes it: float32 accumulators,
    c ascending in steps of 8; ``passes`` 3 is 3xTF32, 1 is plain TF32."""
    K = a.shape[1]
    pad = -K % MMA_K
    a = torch.nn.functional.pad(a, (0, pad))
    x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    (ah, al), (xh, xl) = split(a), split(x)
    terms = ((al, xh), (ah, xl), (ah, xh))[3 - passes:]
    acc = torch.zeros((a.shape[0], x.shape[1]), dtype=torch.float32)
    for k in range(0, K + pad, MMA_K):
        for p, q in terms:
            acc = acc + p[:, k:k + MMA_K] @ q[k:k + MMA_K]
    return acc


def emulated(a: torch.Tensor, x: torch.Tensor, slot: int, passes: int = 3) -> torch.Tensor:
    """The product over ``slot``-term partials, summed in float32 in order
    (the combine's fixed order)."""
    out = torch.zeros((a.shape[0], x.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], slot):
        out = out + slot_partial(a[:, k:k + slot], x[k:k + slot], passes)
    return out


def data(K: int, seed: int, integer: bool = False):
    rng = np.random.default_rng(seed)
    M, N = 64, 40
    draw = (lambda s: rng.integers(-4, 5, s)) if integer else rng.standard_normal
    return (torch.from_numpy(draw((M, K)).astype(np.float32)),
            torch.from_numpy(draw((K, N)).astype(np.float32)))


def rel_err(got: torch.Tensor, a: torch.Tensor, x: torch.Tensor) -> float:
    want = a.double() @ x.double()
    return float((got.double() - want).abs().max() / want.abs().max())


def test_rounding_is_tf32_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0]
    assert tf32_rna(x).tolist() == want
    hi, lo = split(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)


@pytest.mark.parametrize("name,K,slot", CASES, ids=IDS)
def test_tf32x3_within_a_tenth_of_the_kernel_tolerance(name, K, slot):
    a, x = data(K, seed=K)
    err = rel_err(emulated(a, x, slot), a, x)
    assert err <= KERNEL_TOL / 10, f"{name}: {err:.3e}"


@pytest.mark.parametrize("name,K,slot", CASES, ids=IDS)
def test_integer_data_is_exact(name, K, slot):
    a, x = data(K, seed=K + 1, integer=True)
    want = (a.long() @ x.long()).float()
    assert torch.equal(emulated(a, x, slot), want)


@pytest.mark.parametrize("name,K,slot", CASES, ids=IDS)
def test_single_pass_tf32_errs_at_least_30x_more(name, K, slot):
    a, x = data(K, seed=K + 2)
    three, one = rel_err(emulated(a, x, slot), a, x), rel_err(emulated(a, x, slot, 1), a, x)
    assert one >= 30 * three, f"{name}: TF32 {one:.3e} vs 3xTF32 {three:.3e}"


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
def test_emulated_kernel_matches_pallas(integer):
    B, Gt, gt, nb, N = 128, 2, 1, 3, 129
    rng = np.random.default_rng(5)
    draw = (lambda s: rng.integers(-4, 5, s)) if integer else rng.standard_normal
    tiles = draw((gt, Gt * B, B)).astype(np.float32)
    bcol = rng.integers(0, nb, (gt, Gt)).astype(np.int32)
    Xb = draw((nb, B, N)).astype(np.float32)
    Npad = -(-N // 128) * 128
    want = np.asarray(j_spmm.super_tile_spmm(
        jnp.asarray(tiles), jnp.asarray(bcol),
        jnp.pad(jnp.asarray(Xb), ((0, 0), (0, 0), (0, Npad - N))),
        block_n=Npad, interpret=True))[..., :N]
    t = torch.from_numpy(tiles).view(gt * Gt, B, B)
    got = np.stack([emulated(t[s], torch.from_numpy(Xb[bcol.reshape(-1)[s]]), B).numpy()
                    for s in range(gt * Gt)]).reshape(want.shape)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

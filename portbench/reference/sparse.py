"""A COO matrix product in plain PyTorch, in the precision asked for.

Triplets may come as numpy arrays or as tensors."""
from __future__ import annotations

import torch


class Coo:
    """COO triplets on a device: y = A @ x as one ``index_add_`` per block of entries."""

    def __init__(self, rows, cols, vals,
                 shape: tuple[int, int], device, dtype=torch.float64,
                 round_fn=None, block: int = 1 << 25):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.round_fn = round_fn or (lambda t: t)
        self.rows = torch.as_tensor(rows, device=device).to(torch.int64)
        self.cols = torch.as_tensor(cols, device=device).to(torch.int64)
        v = torch.as_tensor(vals, device=device).to(dtype)
        self.vals = self.round_fn(v)
        self.block = int(block)

    @property
    def device(self):
        return self.rows.device

    def matvec(self, x: torch.Tensor, absolute: bool = False) -> torch.Tensor:
        """A @ x (|A| @ |x| with ``absolute``), accumulated in ``self.dtype``."""
        x = self.round_fn(x.to(self.device, self.dtype))
        if absolute:
            x = x.abs()
        y = torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)
        for s in range(0, self.rows.numel(), self.block):
            e = slice(s, s + self.block)
            v = self.vals[e].abs() if absolute else self.vals[e]
            y.index_add_(0, self.rows[e], v * x[self.cols[e]])
        return y


def of_matrix(matrix: dict, device, dtype=torch.float64, round_fn=None) -> Coo:
    """The benchmark's matrix (a generator's triplets) as a ``Coo``."""
    return Coo(matrix["rows"], matrix["cols"], matrix["vals"], matrix["shape"], device,
               dtype=dtype, round_fn=round_fn)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    t = t.to(torch.float32).contiguous()
    bits = t.view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)

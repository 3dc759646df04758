"""CB211 negative: launch paths reading only host metadata; reads off the path."""
import torch


def forward(params, h: torch.Tensor, group_size: int = 1):
    B = int(h.shape[0])
    n = int(h.numel()) // max(1, int(group_size))
    scale = float(h.shape[-1]) ** -0.5
    return torch.where(h > 0, h * scale, h), B, n


def report(h: torch.Tensor) -> dict:
    # not a launch path: a host-side summary after the run
    return {"max": float(h.max()), "rows": h.tolist(), "host": h.cpu()}

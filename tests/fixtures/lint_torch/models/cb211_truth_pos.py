"""CB211 positive: a tensor's truth value tested on a launch path."""
import torch


def forward(params, h: torch.Tensor, mask: torch.Tensor):
    if torch.any(mask):
        h = h * mask
    while h:
        h = h - 1
    assert torch.isfinite(h).all()
    scale = 2.0 if h.max() > 0 else 1.0
    ok = mask and h
    if not torch.equal(h, mask):
        h = h + 1
    rows = [r for r in range(3) if h[r].sum() > 0]
    return h * scale, ok, rows

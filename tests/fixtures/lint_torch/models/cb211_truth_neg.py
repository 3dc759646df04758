"""CB211 negative: truth tests on a launch path that read no tensor's value."""
import torch


def forward(params, h: torch.Tensor, mask: torch.Tensor | None = None, causal: bool = True):
    if mask is not None and causal:
        h = torch.where(mask, h, 0.0)
    if h.shape[0] > 1 and h.dtype == torch.bfloat16:
        h = h.float()
    if not torch.is_grad_enabled() or torch.is_tensor(params):
        h = h.detach()
    assert h.ndim == 3, h.shape
    n = h.numel() if causal else 0
    return h, n


def report(h: torch.Tensor) -> bool:
    # not a launch path: a host-side check after the run
    return bool(h.isfinite().all()) and not torch.any(h < 0)

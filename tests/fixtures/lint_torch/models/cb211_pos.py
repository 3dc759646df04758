"""CB211 positive: host syncs on a launch path (a family's forward and what it calls)."""
import torch


def _norm(h: torch.Tensor, eps: float):
    scale = float(h.abs().max())
    return h / (scale + eps)


def forward(params, h: torch.Tensor, mask: torch.Tensor):
    h = _norm(h, 1e-6)
    if bool(mask.any()):
        h = h * mask
    n = int(torch.count_nonzero(mask))
    torch.cuda.synchronize()
    return h, n, h.sum().item(), h[0].tolist(), h.cpu()


def decode_step(params, state, tokens, pos):
    logits = state["k"] @ params["w"]
    active: torch.Tensor = logits.isfinite().all()
    if not bool(active):
        raise FloatingPointError("non-finite logits")
    return logits

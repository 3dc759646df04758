"""CB211 negative: ``.to()`` on a launch path that stays on the device."""
import torch


def decode_step(params, state, tokens, pos):
    logits = state["k"] @ params["w"]
    return (logits.to(torch.float32), logits.to(device=state["k"].device),
            logits.to("cuda"), tokens.to(logits))


def save(logits: torch.Tensor):
    # not a launch path: what the host keeps after the run
    return logits.to("cpu")

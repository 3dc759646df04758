"""CB211 positive: a copy to the host spelled with ``.to()`` on a launch path."""
import torch


def decode_step(params, state, tokens, pos):
    logits = state["k"] @ params["w"]
    first = logits.to("cpu")
    second = logits.to(device="cpu", dtype=torch.float32)
    third = logits.to(torch.device("cpu"))
    return first, second, third

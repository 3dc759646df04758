"""Batched autoregressive decoding on top of the models' decode_step.

The port of ``repro.serving.decode``. Greedy and temperature sampling
loops. Prefill steps the prompt through ``decode_step`` (cache-filling
teacher forcing), one code path for both phases.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import errors
from repro_torch.models import encdec
from repro_torch.models.model import Model


def build_decode_fn(model: Model) -> Callable:
    """(params, state, tokens, pos) -> (logits, state). The reference jits
    this and donates the state; here it is the plain call (PyTorch runs
    eagerly), and the step never writes the state it is given."""

    def step(params, state, tokens, pos):
        return model.decode_step(params, state, tokens, pos)

    return step


def greedy_decode(
    model: Model,
    params,
    prompts: torch.Tensor,        # (B, P) int32
    max_new_tokens: int,
    *,
    max_len: int | None = None,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    frames: torch.Tensor | None = None,
) -> torch.Tensor:
    """Returns generated tokens (B, max_new_tokens) int32. With a
    ``temperature`` above 0 and a ``generator`` it samples (the reference's
    PRNG key becomes the generator); otherwise it takes the argmax.

    ``frames`` (encoder-decoder only, (B, num_frames, d)): the encoder's
    input; the decoder attends to its ``encdec.precompute_cross`` k/v. The
    reference has no such option: without it the cross k/v are the decode
    state's zeros, as in the reference."""
    prompts = torch.as_tensor(prompts, device=model.device)
    B, P = prompts.shape
    max_len = max_len or (P + max_new_tokens)
    state = model.init_decode_state(B, max_len)
    if frames is not None:
        if model.cfg.family != "encdec":
            raise errors.InvalidArgError(f"frames= needs the encdec family, not "
                                         f"{model.cfg.family!r}")
        state["cross"] = encdec.precompute_cross(params, model.cfg, frames)
    step_fn = build_decode_fn(model)

    logits = None
    for t in range(P):                       # prefill (cache-filling)
        pos = torch.full((B,), t, dtype=torch.int32, device=model.device)
        logits, state = step_fn(params, state, prompts[:, t:t + 1], pos)

    outs = []
    tok = _select(logits, temperature, generator)
    for t in range(max_new_tokens):
        outs.append(tok)
        pos = torch.full((B,), P + t, dtype=torch.int32, device=model.device)
        logits, state = step_fn(params, state, tok[:, None], pos)
        tok = _select(logits, temperature, generator)
    return torch.stack(outs, dim=1)


def _select(logits: torch.Tensor, temperature: float, generator) -> torch.Tensor:
    if temperature <= 0.0 or generator is None:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

"""Unified model API, the port of ``repro.models.model``.

    model = Model(cfg)                        # on CUDA; Model(cfg, "cpu") on the CPU
    params = model.init(generator)            # an nn.Module of float32 weights
    axes = model.axes()                       # logical axes, in the reference's layout
    out = model.forward(params, tokens)
    loss, metrics = model.loss(params, batch) # batch: tokens, targets (+ patch_embeds)
    state = model.init_decode_state(batch, max_len)
    logits, state = model.decode_step(params, state, tokens, pos)

The dense and VLM families are ported (``transformer``); the others raise
``errors.InvalidArgError``. CB sparsity specs (``cfg.sparse_mlp``) are
built at construction: they are structural (numpy only), shared by every
layer, and bit-equal to the reference's. ``init`` returns the parameters
alone; ``axes()`` gives their logical-axis tree in the reference's layout
(``param_tree``), for ``sharding.logical_to_sharding``.
``params_from_numpy`` brings the reference's parameter tree across and
``param_tree`` maps the parameters (or anything with one value per
parameter, such as an optimizer's moments) back into it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.streams import _as_tensor, resolve_device

from . import transformer
from .layers import build_mlp_specs


class Model:
    """``impl`` is that of the sparse MLP's products (``cb_linear_apply``):
    ``"cuda"`` (the kernels) or ``"reference"`` (the plain oracle)."""

    def __init__(self, cfg: ModelConfig, device=None, *, impl: str = "cuda"):
        transformer.check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.impl = impl
        self.specs = build_mlp_specs(cfg) if cfg.sparse_mlp else None

    def axes(self) -> dict:
        return transformer.lm_axes(self.cfg)

    def init(self, generator: torch.Generator) -> transformer.LM:
        return transformer.lm_init(generator, self.cfg, specs=self.specs, device=self.device)

    def forward(self, params, tokens, **kw) -> transformer.LMOutputs:
        return transformer.forward(params, self.cfg, tokens, specs=self.specs,
                                   impl=self.impl, **kw)

    def loss(self, params, batch, **kw):
        return transformer.lm_loss(params, self.cfg, batch, specs=self.specs,
                                   impl=self.impl, **kw)

    def init_decode_state(self, batch: int, max_len: int) -> dict:
        return transformer.init_decode_state(self.cfg, batch, max_len, device=self.device)

    def decode_step(self, params, state, tokens, pos):
        return transformer.decode_step(params, self.cfg, state, tokens, pos,
                                       specs=self.specs, impl=self.impl)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> transformer.LM:
    """The port's parameters from the reference's ``Model.init`` tree as numpy
    arrays: ``embed``, ``layers`` stacked on axis 0 (``attn.wq`` (L, d, H, dh),
    ..., ``ffn.{gate,up,down}.tiles`` (L, nt, B, B) or ``ffn.w_*``, ``norm1`` /
    ``norm2`` (L, d)), ``final_norm`` and, unless tied, ``unembed``. The
    layers are unstacked into ``DecoderLayer``s, bit for bit, on ``device``
    (default CUDA)."""
    transformer.check_family(cfg)
    return lm_from_tree(tree, device)


def lm_from_tree(tree: dict, device=None) -> transformer.LM:
    """``params_from_numpy`` without the config: the tree alone says the depth
    (the stacked axis), whether the MLP is sparse (``{"tiles": ...}``
    projections) and whether the embedding is tied (no ``unembed``)."""
    dev = resolve_device(device)

    def t(a):
        return _as_tensor(np.asarray(a)).to(dev)

    lyr = tree["layers"]
    sparse = isinstance(next(iter(lyr["ffn"].values())), dict)

    def ffn(i):
        if sparse:
            return {k: {"tiles": t(v["tiles"][i])} for k, v in lyr["ffn"].items()}
        return {k: t(v[i]) for k, v in lyr["ffn"].items()}

    layers = [transformer.DecoderLayer({k: t(v[i]) for k, v in lyr["attn"].items()}, ffn(i),
                                       t(lyr["norm1"][i]), t(lyr["norm2"][i]))
              for i in range(len(lyr["norm1"]))]
    unembed = t(tree["unembed"]) if "unembed" in tree else None
    return transformer.LM(t(tree["embed"]), layers, t(tree["final_norm"]), unembed)


def _path(params: transformer.LM, name: str) -> tuple[list[str], int | None]:
    """A parameter's path in the reference's tree, and its layer (None: not stacked)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return parts, None
    i, rest = int(parts[1]), parts[2:]
    if rest[0] == "ffn" and params.layers[i].sparse:
        rest = rest + ["tiles"]
    return ["layers"] + rest, i


def param_tree(params: transformer.LM, values=None) -> dict:
    """The reference's parameter tree over ``values``, one per parameter in
    ``params.parameters()`` order (default: the parameters themselves). A
    stacked leaf (every ``layers`` entry) holds the list of its layers'
    values; keys are sorted, the order in which JAX flattens the tree."""
    values = list(params.parameters()) if values is None else list(values)
    tree: dict = {}
    for (name, _), v in zip(params.named_parameters(), values, strict=True):
        path, layer = _path(params, name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if layer is None:
            node[path[-1]] = v
        else:
            node.setdefault(path[-1], []).append(v)

    def ordered(node):
        return {k: ordered(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    return ordered(tree)


def tree_values(params: transformer.LM, tree: dict) -> list:
    """The inverse of ``param_tree``: ``tree``'s leaves in ``params.parameters()``
    order, a stacked leaf indexed at each parameter's layer."""
    out = []
    for name, _ in params.named_parameters():
        path, layer = _path(params, name)
        node = tree
        for k in path:
            node = node[k]
        out.append(node if layer is None else node[layer])
    return out

"""Unified model API, the port of ``repro.models.model``.

    model = Model(cfg)                        # on CUDA; Model(cfg, "cpu") on the CPU
    params = model.init(generator)            # an nn.Module of float32 weights
    shapes, axes = model.abstract_init()      # the same on the meta device (dry run)
    axes = model.axes()                       # logical axes, in the reference's layout
    out = model.forward(params, tokens)       # encdec: frames=...
    loss, metrics = model.loss(params, batch) # batch: tokens, targets (+ patch_embeds, frames)
    state = model.init_decode_state(batch, max_len)
    logits, state = model.decode_step(params, state, tokens, pos)
    model = Model(cfg, mesh=mesh)             # on a DeviceMesh: init gives DTensor parameters
    params = model.shard(params)              # or shard weights drawn / loaded whole

Every family of the reference is ported: dense, MoE, SSM and VLM
(``transformer``), hybrid (``hybrid``) and encoder-decoder (``encdec``); an
unknown family raises ``errors.InvalidArgError``. CB sparsity specs
(``cfg.sparse_mlp``) are built at construction: they are structural (numpy
only), shared by every layer, and bit-equal to the reference's. ``init``
returns the parameters alone; ``axes()`` gives their logical-axis tree in
the reference's layout (``param_tree``), for ``sharding.logical_to_sharding``.
``params_from_numpy`` brings the reference's parameter tree across and
``param_tree`` maps the parameters (or anything with one value per
parameter, such as an optimizer's moments) back into it.

``mesh=`` (a ``DeviceMesh`` with ``data`` / ``model`` axes, ``pod`` too) runs
every family on it: ``init`` draws the whole weights on every rank from the
same generator and keeps each rank's part (``sharding.shard_params``, the
reference's layout under the rules of the active ``axis_rules`` on that
mesh, the default rules otherwise); ``forward`` / ``loss`` take a batch
split over ``batch`` (``sharding.place_batch``); ``init_decode_state`` and
``decode_step`` take the decode state as ``DTensor``s laid out by
``decode_state_axes`` under the same rules (``launch.mesh.rules_for`` gives
a decode shape's: run them inside ``axis_rules(mesh, rules_for(...))``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import errors
from repro_torch.configs.base import ModelConfig
from repro_torch.core.streams import _as_tensor, resolve_device

from . import encdec, hybrid, moe, sharding, transformer
from .layers import build_mlp_specs
from .sharding import shard_params


class Model:
    """``impl`` is that of the sparse MLP's products (``cb_linear_apply``):
    ``"cuda"`` (the kernels) or ``"reference"`` (the plain oracle).
    ``expert_shard=(i, n)`` (MoE family only) makes ``init`` give each MoE
    layer shard i of n of its experts, as one chip of n in expert
    parallelism holds them; the reference has no such option. ``mesh``: see
    the module's docstring."""

    def __init__(self, cfg: ModelConfig, device=None, *, impl: str = "cuda",
                 expert_shard: tuple[int, int] | None = None, mesh=None):
        transformer.check_family(cfg)
        if mesh is not None:
            if expert_shard is not None:
                raise errors.InvalidArgError("expert_shard and mesh: the mesh shards the "
                                             "experts over 'model' itself")
        if expert_shard is not None:
            if cfg.family != "moe":
                raise errors.InvalidArgError(f"expert_shard needs the moe family, not "
                                             f"{cfg.family!r}")
            moe.expert_range(cfg, expert_shard)          # checks the shard
        self.cfg = cfg
        self.device = resolve_device(device)
        self.impl = impl
        self.expert_shard = expert_shard
        self.mesh = mesh
        self.specs = build_mlp_specs(cfg) if cfg.sparse_mlp else None
        self._mod = {"hybrid": hybrid, "encdec": encdec}.get(cfg.family, transformer)

    def axes(self) -> dict:
        if self._mod is transformer:
            return transformer.lm_axes(self.cfg)
        if self._mod is hybrid:
            return hybrid.hybrid_axes(self.cfg)
        return encdec.encdec_axes(self.cfg)

    def init(self, generator: torch.Generator | None):
        """The parameters on the model's device, drawn from ``generator`` (on
        the meta device nothing is drawn, and ``generator`` may be None); on
        the model's mesh, each rank's part of them."""
        params = self._init(generator, self.device)
        return params if self.mesh is None else self.shard(params)

    def shard(self, params, mesh=None, device=None):
        """``params`` (whole, equal on every rank) distributed over ``mesh``
        (default: the model's) in place, as ``sharding.shard_params`` lays
        them out, each rank's part moved to ``device`` (default: where it
        is); returns them."""
        mesh = self.mesh if mesh is None else mesh
        if mesh is None:
            raise errors.InvalidArgError("shard needs a mesh: Model(cfg, mesh=) or mesh=")
        return shard_params(params, self, mesh, device)

    def abstract_init(self, generator: torch.Generator | None = None):
        """Shape-only init, the dry run's entry point: the parameters built on
        the meta device (no allocation, no random draw, whatever the model's
        device), as the reference's tree (``param_tree``), and ``axes()``."""
        return param_tree(self._init(generator, torch.device("meta"))), self.axes()

    def _init(self, generator, device: torch.device):
        if self._mod is transformer:
            return transformer.lm_init(generator, self.cfg, specs=self.specs,
                                       device=device, expert_shard=self.expert_shard)
        if self._mod is hybrid:
            return hybrid.hybrid_init(generator, self.cfg, device=device)
        return encdec.encdec_init(generator, self.cfg, device=device)

    def forward(self, params, tokens, **kw) -> transformer.LMOutputs:
        if self._mod is transformer:
            return transformer.forward(params, self.cfg, tokens, specs=self.specs,
                                       impl=self.impl, **kw)
        return self._mod.forward(params, self.cfg, tokens, **kw)

    def loss(self, params, batch, **kw):
        if self._mod is transformer:
            return transformer.lm_loss(params, self.cfg, batch, specs=self.specs,
                                       impl=self.impl, **kw)
        fwd_kw = {"frames": batch["frames"]} if self.cfg.family == "encdec" else {}
        logits = self.forward(params, batch["tokens"], **fwd_kw).logits
        if self.mesh is None:
            xent, _ = transformer.cross_entropy(logits, batch["targets"])
        else:
            xent, _ = transformer.mesh_xent(logits, batch["targets"], params.unembed)
        return xent, {"xent": xent}

    def init_decode_state(self, batch: int, max_len: int) -> dict:
        """Zeros; on the model's mesh each rank's part of them (``shard_state``)."""
        state = self._mod.init_decode_state(self.cfg, batch, max_len, device=self.device)
        return state if self.mesh is None else self.shard_state(state)

    def shard_state(self, state: dict, mesh=None, device=None) -> dict:
        """A whole decode state (equal on every rank) as ``DTensor``s laid out by
        ``decode_state_axes`` under the mesh's rules, as the reference's dry
        run places it (``sanitize_shardings``); each rank keeps its part, on
        ``device`` (default: where it is)."""
        mesh = self.mesh if mesh is None else mesh
        if mesh is None:
            raise errors.InvalidArgError("shard_state needs a mesh: Model(cfg, mesh=) or mesh=")
        return sharding.shard_tree(state, self.decode_state_axes(), mesh, device)

    def decode_state_axes(self) -> dict:
        return self._mod.decode_state_axes(self.cfg)

    def decode_step(self, params, state, tokens, pos):
        if self._mod is transformer:
            return transformer.decode_step(params, self.cfg, state, tokens, pos,
                                           specs=self.specs, impl=self.impl)
        return self._mod.decode_step(params, self.cfg, state, tokens, pos)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None, *, model=None):
    """The port's parameters from the reference's ``Model.init`` tree as numpy
    arrays, bit for bit, on ``device`` (default CUDA): leaves stacked on a
    layer axis are unstacked into per-layer modules (``lm_from_tree``). With
    ``model`` on a mesh, each rank's part of them (``Model.shard``; the
    whole tree is read on the host)."""
    transformer.check_family(cfg)
    if model is None or model.mesh is None:
        return lm_from_tree(tree, device)
    return model.shard(lm_from_tree(tree, "cpu"), device=resolve_device(device))


def decode_state_from_numpy(model, tree: dict, device=None) -> dict:
    """A decode state from the reference's (``init_decode_state`` or a decode
    step's, as numpy), on ``device`` (default CUDA); on the model's mesh each
    rank's part of it (``Model.shard_state``; the whole tree is read on the
    host)."""
    def t(node, dev):
        if isinstance(node, dict):
            return {k: t(v, dev) for k, v in node.items()}
        return _as_tensor(np.asarray(node)).reshape(np.shape(node)).to(dev)

    dev = resolve_device(device)
    if model.mesh is None:
        return t(tree, dev)
    return model.shard_state(t(tree, torch.device("cpu")), device=dev)


def _index(tree, i: int):
    """Layer ``i`` of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(tree)


def lm_from_tree(tree: dict, device=None):
    """``params_from_numpy`` without the config: the tree alone says the
    family and its depth (the stacked axes), whether the MLP is sparse
    (``{"tiles": ...}`` projections) and whether the embedding is tied (no
    ``unembed``). ``encoder`` / ``decoder`` is encdec; ``mamba`` / ``shared``
    / ``lora`` is hybrid; ``layers.mixer`` is ssm; ``layers.{dense, moe}`` is
    llama4's interleave; ``layers.ffn.router`` is moe; the rest dense / VLM."""
    dev = resolve_device(device)

    def t(a):
        if isinstance(a, dict):
            return {k: t(v) for k, v in a.items()}
        return _as_tensor(np.asarray(a)).to(dev)

    def unstack(sub) -> list:
        """A stacked subtree's layers, split on the host."""
        return [_index(sub, i) for i in range(_depth(sub))]

    if "encoder" in tree:
        return encdec.EncDecLM(t(tree["embed"]), [t(p) for p in unstack(tree["encoder"])],
                               [t(p) for p in unstack(tree["decoder"])], t(tree["enc_norm"]),
                               t(tree["final_norm"]), t(tree["unembed"]))
    if "mamba" in tree:
        return hybrid.HybridLM(t(tree["embed"]), [t(p) for p in unstack(tree["mamba"])],
                               t(tree["shared"]), t(tree["lora"]), t(tree["final_norm"]),
                               t(tree["unembed"]))

    def layer(p: dict):
        if "mixer" in p:
            return transformer.param_dict(t(p))
        if "moe" in p:
            return torch.nn.ModuleDict({
                "dense": torch.nn.ModuleList([layer(d) for d in unstack(p["dense"])]),
                "moe": layer(p["moe"])})
        p = t(p)
        return transformer.DecoderLayer(p["attn"], p["ffn"], p["norm1"], p["norm2"])

    layers = [layer(p) for p in unstack(tree["layers"])]
    unembed = t(tree["unembed"]) if "unembed" in tree else None
    return transformer.LM(t(tree["embed"]), layers, t(tree["final_norm"]), unembed)


def _path(params, name: str) -> tuple[list[str], tuple[int, ...]]:
    """A parameter's path in the reference's tree and its indices on the
    stacked axes (a layer; a llama4 group, then its dense layer): the name's
    integer parts are the indices, the rest the path."""
    parts = name.split(".")
    path = [p for p in parts if not p.isdigit()]
    idx = tuple(int(p) for p in parts if p.isdigit())
    if path[:2] == ["layers", "ffn"] and getattr(params.layers[idx[0]], "sparse", False):
        path.append("tiles")
    return path, idx


def param_tree(params, values=None) -> dict:
    """The reference's parameter tree over ``values``, one per parameter in
    ``params.parameters()`` order (default: the parameters themselves). A
    stacked leaf holds the list of its layers' values (a list of lists for a
    llama4 group's dense layers); keys are sorted, the order in which JAX
    flattens the tree."""
    values = list(params.parameters()) if values is None else list(values)
    tree: dict = {}
    for (name, _), v in zip(params.named_parameters(), values, strict=True):
        path, idx = _path(params, name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if not idx:
            node[path[-1]] = v
            continue
        lst = node.setdefault(path[-1], [])
        for i in idx[:-1]:
            while len(lst) <= i:
                lst.append([])
            lst = lst[i]
        assert len(lst) == idx[-1], (name, len(lst))
        lst.append(v)

    def ordered(node):
        return {k: ordered(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    return ordered(tree)


def tree_values(params, tree: dict) -> list:
    """The inverse of ``param_tree``: ``tree``'s leaves in ``params.parameters()``
    order, a stacked leaf indexed at each parameter's layer."""
    out = []
    for name, _ in params.named_parameters():
        path, idx = _path(params, name)
        node = tree
        for k in path:
            node = node[k]
        for i in idx:
            node = node[i]
        out.append(node)
    return out

"""Mamba2 (SSD, state-space duality) block, chunked-parallel.

The port of ``repro.models.ssm`` (``src/repro/models/ssm.py``). Within a
chunk the interactions are dense (Q x Q) products; across chunks the state
is carried by a recurrence, here a Python loop over the chunks. The
recurrence runs in float32 whatever the activation dtype; inputs and
outputs follow the activation dtype.

Decode is a single-step state update: S <- exp(dt*A) S + dt * x B^T,
y = C.S, O(1) per token.

The reference holds no Pallas kernel here: its SSD is ``jnp`` and
``lax.scan``, so plain torch ops are the port. One difference, on purpose:
``ssd_chunked`` masks the segment sums before the exponential (see there),
so that its backward is finite at any chunk length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import errors
from repro_torch.configs.base import ModelConfig
from repro_torch.core.streams import resolve_device

from . import sharding as S
from .layers import _normal, rmsnorm, rmsnorm_split


def _dims(cfg: ModelConfig):
    d_in = cfg.d_model * cfg.ssm_expand
    nh = d_in // cfg.ssm_headdim
    return d_in, nh, cfg.ssm_headdim, cfg.ssm_state


def ssm_axes(cfg: ModelConfig) -> dict:
    # in_proj is split into z / xBC / dt projections so that each output dim
    # shards over the model axis on its own.
    return {
        "in_z": ("w_embed", "mlp"),
        "in_xbc": ("w_embed", "mlp"),
        "in_dt": ("w_embed", None),
        "conv_w": (None, "mlp"),
        "conv_b": ("mlp",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm_w": ("mlp",),
        "out_proj": ("mlp", "w_embed"),
    }


def ssm_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """One mixer's float32 weights: the reference's shapes, scales and constants."""
    dev = resolve_device(device)
    d = cfg.d_model
    d_in, nh, hd, ds = _dims(cfg)
    conv_ch = d_in + 2 * ds
    return {
        "in_z": _normal(generator, (d, d_in), d**-0.5, dev),
        "in_xbc": _normal(generator, (d, d_in + 2 * ds), d**-0.5, dev),
        "in_dt": _normal(generator, (d, nh), d**-0.5, dev),
        "conv_w": _normal(generator, (cfg.ssm_conv_width, conv_ch), 0.1, dev),
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((nh,), -2.0, dtype=torch.float32, device=dev),
        "norm_w": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": _normal(generator, (d_in, d), d_in**-0.5, dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B, L, C), w (W, C); the taps summed in order."""
    W, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:L, :] * w[0][None, None, :]
    for i in range(1, W):
        out = out + xp[:, i:i + L, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _in_proj(params, x: torch.Tensor, dt_):
    """Split z / xBC / dt projections."""
    z = x @ params["in_z"].to(dt_)
    xBC = x @ params["in_xbc"].to(dt_)
    dt = x @ params["in_dt"].to(dt_)
    return z, xBC, dt


class _Mesh:
    """How a mixer with ``DTensor`` weights computes on its mesh (see
    ``ssm_apply``): ``tp`` when its ``mlp`` dims (z, xBC's channels, the
    norm, out_proj's rows) split over ``model``; ``w(name)`` is the rank's
    weight, its gradient summed over ``model`` where it is replicated there
    (each rank uses it for its part); ``heads`` the SSD heads this rank runs."""

    def __init__(self, params, cfg: ModelConfig, heads_split: bool):
        self.params = params
        self.mesh = S.param_mesh(params["in_z"])
        self.tp = S.model_sharded(params["in_z"])
        split = [k for k in ("in_xbc", "conv_w", "conv_b", "norm_w", "out_proj")
                 if S.model_sharded(params[k])]
        if not self.tp and split:
            raise errors.InvalidArgError(
                f"SSM weights {split} are split over 'model' but in_z is not: the mixer "
                "splits its 'mlp' dims together")
        self.xbc_split = self.tp and S.model_sharded(params["in_xbc"])
        self.part = ("model",) if self.tp else ()
        nh = _dims(cfg)[1]
        if self.tp and heads_split:
            n = nh // S.axis_size(self.mesh, "model")
            self.heads = slice(S.axis_rank(self.mesh, "model") * n, (S.axis_rank(self.mesh,
                                                                               "model") + 1) * n)
        else:
            self.heads = slice(0, nh)

    def w(self, name: str) -> torch.Tensor:
        return S.local_param(self.params[name], self.part)


def _heads_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the SSD's heads split over ``model`` in the full-sequence
    forward: the rules map ``heads`` to it (the reference constrains xh so)
    and the heads divide; otherwise every rank runs all of them (the
    reference's ``sanitize_shardings`` replicates such a dim) and keeps its
    part of ``d_in`` after the SSD."""
    if mesh is None or S.axis_size(mesh, "model") == 1:
        return False
    return "model" in S.rule_axes(mesh, "heads") and \
        _dims(cfg)[1] % S.axis_size(mesh, "model") == 0


def _finish(m: _Mesh, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor, dt_) -> torch.Tensor:
    """The gated norm and out_proj of the SSD's output y (this rank's heads,
    ``d_in`` last): on a split mixer the rank's part of ``d_in``, the norm's
    sum of squares and out_proj's row-parallel partial sums added over
    ``model``."""
    if not m.tp:
        y = rmsnorm(y * F.silu(z), m.w("norm_w"))
        return y @ m.w("out_proj").to(dt_)
    if m.heads.stop - m.heads.start == _dims(cfg)[1]:
        y = S._my_part(y, m.mesh, "model", y.ndim - 1)      # every head ran here
    y = rmsnorm_split(y * F.silu(z), m.w("norm_w"), m.mesh, _dims(cfg)[0])
    return S.reduce_over(y @ m.w("out_proj").to(dt_), m.mesh, ("model",))


def ssd_chunked(
    xh: torch.Tensor,    # (B, L, nh, hd)
    dt: torch.Tensor,    # (B, L, nh), post-softplus
    A: torch.Tensor,     # (nh,) negative
    Bm: torch.Tensor,    # (B, L, ds)
    Cm: torch.Tensor,    # (B, L, ds)
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (B, nh, hd, ds)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B, L, nh, hd) float32, final state float32)."""
    B_, L, nh, hd = xh.shape
    ds = Bm.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    f32 = torch.float32

    xf = xh.to(f32).reshape(B_, nc, Q, nh, hd)
    dtf = dt.to(f32).reshape(B_, nc, Q, nh)
    Bf = Bm.to(f32).reshape(B_, nc, Q, ds)
    Cf = Cm.to(f32).reshape(B_, nc, Q, ds)

    da = dtf * A[None, None, None, :]                # (B, nc, Q, nh), <= 0
    cum = torch.cumsum(da, dim=2)                     # inclusive
    total = cum[:, :, -1, :]                          # (B, nc, nh)

    # ---- intra-chunk (dense QxQ attention-like product) ---------------------
    G = torch.einsum("bcqs,bcks->bcqk", Cf, Bf)       # (B, nc, Q, Q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, Q, K, nh)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    # The reference takes where(causal, exp(seg), 0) (src/repro/models/ssm.py:108-110).
    # Above the diagonal seg is large and positive, exp overflows to inf there,
    # and the where's backward multiplies 0 * inf: non-finite gradients at long
    # chunks (ROADMAP C.8). Masking seg first gives the same forward values and
    # a finite backward.
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, float("-inf")))
    M = G[..., None] * decay * dtf[:, :, None, :, :]  # weight at key pos
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xf)

    # ---- chunk boundary states ---------------------------------------------
    # the contribution of chunk c to its outgoing state
    w_in = torch.exp(total[:, :, None, :] - cum) * dtf          # (B, nc, Q, nh)
    S_in = torch.einsum("bcks,bckhp,bckh->bchps", Bf, xf, w_in)  # (B, nc, nh, hd, ds)

    S = (torch.zeros((B_, nh, hd, ds), dtype=f32, device=xh.device)
         if initial_state is None else initial_state.to(f32))
    S_prevs = []                                      # each chunk's incoming state
    for c in range(nc):
        S_prevs.append(S)
        S = torch.exp(total[:, c])[:, :, None, None] * S + S_in[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)             # (B, nc, nh, hd, ds)

    # ---- inter-chunk output -------------------------------------------------
    y_inter = torch.einsum("bcqs,bchps,bcqh->bcqhp", Cf, S_prevs, torch.exp(cum))
    y = (y_intra + y_inter).reshape(B_, L, nh, hd)
    return y, S


def ssm_apply(params, cfg: ModelConfig, x: torch.Tensor,
              state: dict | None = None) -> tuple[torch.Tensor, None]:
    """Full-sequence forward (training / prefill). x (B, L, d).

    On a mesh (``DTensor`` weights, x this rank's rows) the reference's
    layout (``src/repro/models/ssm.py:165,171``): z / xBC / norm / out_proj
    split by ``mlp`` over ``model``, the depthwise conv on the rank's
    channels of xBC, then xBC gathered over ``model`` so that each rank holds
    its heads of x (``heads -> model``; all of them where they do not divide)
    and all of B and C; the gated norm's sum of squares and out_proj's
    row-parallel partial sums added over ``model``."""
    dt_ = x.dtype
    d_in, nh, hd, ds = _dims(cfg)
    m = _Mesh(params, cfg, _heads_split(cfg, S.param_mesh(params["in_z"])))
    if m.tp:
        x = S.sum_grad(x, m.mesh)
    z = x @ m.w("in_z").to(dt_)
    xBC = x @ m.w("in_xbc").to(dt_)
    dt_raw = x @ m.w("in_dt").to(dt_)
    xBC = F.silu(_causal_conv(xBC, m.w("conv_w").to(dt_), m.w("conv_b").to(dt_)))
    if m.xbc_split:
        xBC = S.gather_over(xBC, m.mesh, "model", xBC.ndim - 1)
    h = m.heads
    xs = xBC[..., h.start * hd:h.stop * hd]
    Bm = xBC[..., d_in:d_in + ds]
    Cm = xBC[..., d_in + ds:]
    dt = F.softplus(dt_raw.float()[..., h] + m.w("dt_bias")[h][None, None, :])
    A = -torch.exp(m.w("A_log")[h])
    xh = xs.reshape(*xs.shape[:-1], h.stop - h.start, hd)
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + m.w("D")[h][None, None, :, None] * xh.float()
    y = y.reshape(*x.shape[:-1], (h.stop - h.start) * hd).to(dt_)
    return _finish(m, cfg, y, z, dt_), None


def ssm_state_init(cfg: ModelConfig, batch: int, n_layers: int, device=None) -> dict:
    dev = resolve_device(device)
    d_in, nh, hd, ds = _dims(cfg)
    conv_ch = d_in + 2 * ds
    return {
        "ssd": torch.zeros((n_layers, batch, nh, hd, ds), dtype=torch.float32, device=dev),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=torch.float32, device=dev),
    }


SSM_STATE_AXES = {"ssd": (None, "batch", "heads", None, None),
                  "conv": (None, "batch", None, "mlp")}


def ssm_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                    state: dict) -> tuple[torch.Tensor, dict]:
    """Single-token step. x (B, 1, d); state {"ssd", "conv"} of one layer.
    Returns (out (B, 1, d), new state); ``state`` is not written.

    On a mesh the state is this rank's part of it (``SSM_STATE_AXES``): the
    conv history holds the rank's xBC channels (``mlp``), the SSD state its
    heads, or all of them where the rules replicate ``heads`` (decode) or
    they do not divide; the rest is ``ssm_apply``'s layout."""
    dt_ = x.dtype
    d_in, nh, hd, ds = _dims(cfg)
    m = _Mesh(params, cfg, state["ssd"].shape[1] < nh)
    z = x[:, 0, :] @ m.w("in_z").to(dt_)
    xBC = x[:, 0, :] @ m.w("in_xbc").to(dt_)
    dt_raw = x[:, 0, :] @ m.w("in_dt").to(dt_)
    # conv ring: state["conv"] (B, W-1, C) holds the previous inputs
    hist = torch.cat([state["conv"].to(dt_), xBC[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist, m.w("conv_w").to(dt_))
    xBC_t = F.silu(conv_out + m.w("conv_b").to(dt_))
    new_conv = hist[:, 1:, :].float()
    if m.xbc_split:
        xBC_t = S.all_gather(xBC_t, m.mesh, "model", 1)

    h = m.heads
    xs = xBC_t[..., h.start * hd:h.stop * hd]
    Bm = xBC_t[..., d_in:d_in + ds].float()
    Cm = xBC_t[..., d_in + ds:].float()
    dt = F.softplus(dt_raw.float()[..., h] + m.w("dt_bias")[h][None, :])
    A = -torch.exp(m.w("A_log")[h])
    xh = xs.reshape(-1, h.stop - h.start, hd).float()

    st = state["ssd"]                                       # (B, nh, hd, ds)
    decay = torch.exp(dt * A[None, :])                      # (B, nh)
    S_new = decay[:, :, None, None] * st + torch.einsum("bh,bhp,bs->bhps", dt, xh, Bm)
    y = torch.einsum("bs,bhps->bhp", Cm, S_new)             # (B, nh, hd)
    y = y + m.w("D")[h][None, :, None] * xh
    y = y.reshape(-1, (h.stop - h.start) * hd).to(dt_)
    out = _finish(m, cfg, y, z, dt_)[:, None, :]
    return out, {"ssd": S_new, "conv": new_conv}

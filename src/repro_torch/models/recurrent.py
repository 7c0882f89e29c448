"""The RG-LRU recurrent block of Griffin / RecurrentGemma (counterpart of
``repro/models/recurrent.py``).

The recurrence  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
a_t = exp(-c · softplus(Λ) · r_t),  r_t = σ(u_t W_a),  i_t = σ(u_t W_i),
is a diagonal linear RNN.  The reference evaluates it with
``jax.lax.associative_scan`` (plain XLA, no Pallas kernel); the port runs a
log-depth doubling scan with the same combine,
``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)``, in f32.  A cumulative-product
form (``h = A·cumsum(bx / A)``) is not an option: ``log a`` reaches ``-c``
per step, so ``A`` underflows f32 within a dozen steps.

Block layout: two input projections (the wide branch ``w_x`` and the GeLU
gate branch ``w_gate_branch``), a short causal depthwise conv on the wide
branch, the RG-LRU (gates ``w_a_gate``, ``w_i_gate``), the gated merge and
the output projection ``w_out``.  All five matrices go through
``layers.matmul``, so they run the ``nm_spmm`` kernel on compressed leaves;
the conv and Λ stay dense (the sparsity config excludes them).

Over a model axis the projections are output-sharded and ``w_out``
reduction-sharded (``layers.matmul`` combines them).  On a split slab the
state ``(B, W)`` holds the rank's ``W/S`` columns, as the reference's
``cache_pspecs`` places it (width on ``model``); the recurrence is
elementwise over the width, so the rank runs it on those columns alone:
``w_x`` and the conv stay whole (the conv tail is whole on every rank, its
axis of ``conv_width - 1`` does not split), the gates and the GeLU branch
give only the rank's columns (``layers.matmul_cols``: no gather) and
``w_out`` takes the rank's ``y`` as its reduction slice
(``layers.matmul_own``: no gather).  A decode step then runs 2 collectives
a layer (``w_x``'s gather, ``w_out``'s sum) instead of 5.  On a pool the
state is whole on every rank (the reference keeps per-lane states
replicated there) and so is the recurrence.

One difference from the reference: a prompt shorter than ``conv_width -
1`` leaves a conv tail left-padded with zeros (what the causal conv saw
before position 0); the reference keeps the short tail, which its cache
write then broadcasts or refuses.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.kernels import sharded
from repro_torch.models.layers import matmul, matmul_cols, matmul_own


def held_width(width: int, shards: int) -> int:
    """The state columns a rank holds on a slab split over ``shards``
    model-axis ranks: its share where they split evenly, else all."""
    return width // shards if shards > 1 and width % shards == 0 else width


def _proj(u: torch.Tensor, w, cols) -> torch.Tensor:
    """``u @ w``, or with ``cols = (c0, c1)`` its columns ``[c0, c1)``
    only: an output-sharded leaf's own columns with no gather, else sliced
    from the whole output."""
    if cols is None:
        return matmul(u, w)
    y = matmul_cols(u, w)
    return y if y.shape[-1] == cols[1] - cols[0] else y[..., cols[0]:cols[1]]


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t·h_{t-1} + b_t`` along axis 1 (h_{-1} =
    0) by doubling: after the step of offset ``d`` every position holds the
    composition of the ``2d`` steps ending at it."""
    d, s = 1, a.shape[1]
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_scan(x: torch.Tensor, u: torch.Tensor, p: dict, cfg: RGLRUConfig,
               init_state=None, cols=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, W) the conv'd branch; u: (B, S, d_model) the block input
    (for the gates); init_state: (B, W) or None.  Returns ``(h (B, S, W),
    final state (B, W))``, both f32.  With ``cols = (c0, c1)`` x and the
    state are those columns of the width, and so are ``h`` and the
    gates."""
    lam = F.softplus(p["a_log_lambda"].float())  # (W,) > 0
    if cols is not None:
        lam = lam[cols[0]:cols[1]]
    r = torch.sigmoid(_proj(u, p["w_a_gate"], cols).float())
    i = torch.sigmoid(_proj(u, p["w_i_gate"], cols).float())
    log_a = -cfg.c * lam * r  # <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = beta * i * x.float()
    if init_state is not None:
        # the carried state enters as a virtual step before position 0
        bx = torch.cat([bx[:, :1] + a[:, :1] * init_state.float()[:, None], bx[:, 1:]], 1)
    h = _scan(a, bx)
    return h, h[:, -1]


def rglru_block(u: torch.Tensor, p: dict, cfg: RGLRUConfig, init_state=None,
                conv_state=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Griffin recurrent block over ``u`` (B, S, d_model), from zero
    state or from ``(init_state (B, W), conv_state (B, conv_width-1, W))``.
    Returns ``(out (B, S, d_model), lru_state (B, W) f32, conv_state)``.
    An ``init_state`` narrower than the width holds this rank's columns
    (a split slab, :func:`held_width`): the recurrence runs on them alone
    and the state returned is theirs (module docstring)."""
    s = u.shape[1]
    x = matmul(u, p["w_x"])
    width = x.shape[-1]
    cols = (sharded.own_range(width) if init_state is not None
            and init_state.shape[-1] < width else None)
    gate = F.gelu(_proj(u, p["w_gate_branch"], cols).float(), approximate="tanh")
    conv_w = p["conv_w"]
    w = conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros(x.shape[:1] + (w - 1,) + x.shape[2:], dtype=x.dtype,
                                 device=x.device)
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    xc = sum(full[:, j:j + s] * conv_w[j] for j in range(w))
    if cols is not None:
        xc = xc[..., cols[0]:cols[1]]
    h, final = rglru_scan(xc, u, p, cfg, init_state, cols)
    y = (h * gate).to(u.dtype)
    out = matmul(y, p["w_out"]) if cols is None else matmul_own(y, p["w_out"])
    return out, final, full[:, s:]


def rglru_decode_step(u: torch.Tensor, p: dict, cfg: RGLRUConfig, lru_state: torch.Tensor,
                      conv_state: torch.Tensor):
    """One token per lane: u (B, 1, d_model) -> ``(out, lru_state, conv_state)``."""
    return rglru_block(u, p, cfg, lru_state, conv_state)

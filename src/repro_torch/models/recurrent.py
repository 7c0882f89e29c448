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

One difference from the reference: a prompt shorter than ``conv_width -
1`` leaves a conv tail left-padded with zeros (what the causal conv saw
before position 0); the reference keeps the short tail, which its cache
write then broadcasts or refuses.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.models.layers import matmul


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
               init_state=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, W) the conv'd branch; u: (B, S, d_model) the block input
    (for the gates); init_state: (B, W) or None.  Returns ``(h (B, S, W),
    final state (B, W))``, both f32."""
    lam = F.softplus(p["a_log_lambda"].float())  # (W,) > 0
    r = torch.sigmoid(matmul(u, p["w_a_gate"]).float())
    i = torch.sigmoid(matmul(u, p["w_i_gate"]).float())
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
    Returns ``(out (B, S, d_model), lru_state (B, W) f32, conv_state)``."""
    s = u.shape[1]
    x = matmul(u, p["w_x"])
    gate = F.gelu(matmul(u, p["w_gate_branch"]).float(), approximate="tanh")
    conv_w = p["conv_w"]
    w = conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros(x.shape[:1] + (w - 1,) + x.shape[2:], dtype=x.dtype,
                                 device=x.device)
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    xc = sum(full[:, j:j + s] * conv_w[j] for j in range(w))
    h, final = rglru_scan(xc, u, p, cfg, init_state)
    y = (h * gate).to(u.dtype)
    return matmul(y, p["w_out"]), final, full[:, s:]


def rglru_decode_step(u: torch.Tensor, p: dict, cfg: RGLRUConfig, lru_state: torch.Tensor,
                      conv_state: torch.Tensor):
    """One token per lane: u (B, 1, d_model) -> ``(out, lru_state, conv_state)``."""
    return rglru_block(u, p, cfg, lru_state, conv_state)

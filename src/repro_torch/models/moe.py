"""Mixture-of-Experts MLP with sort-based capacity dispatch (counterpart of
``repro/models/moe.py``).

1. top-k routing per token, from an f32 router;
2. the (token, expert) pairs sorted by expert, stably;
3. each pair's slot is ``expert·C + rank within its expert``; pairs past
   the capacity ``C`` are dropped;
4. token activations gathered into an ``(E, C, d)`` buffer (empty slots
   are zero rows);
5. the expert matmuls over the whole buffer: a compressed ``(E, K·n/m, O)``
   stack is one batched ``nm_spmm`` launch per weight;
6. each token gathers its k expert outputs back, weighted by the
   renormalized gates; always-on shared experts are added.

The same pairs are kept and dropped as in the reference: the top-k comes
from a stable descending sort (lower expert index first among equal
probabilities, as ``jax.lax.top_k``; ``torch.topk`` orders ties otherwise)
and the expert order from a stable sort.  Pad tokens route and take
capacity like any other, as in the reference.  The Switch load-balancing
loss is returned beside the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L


def moe_capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def expert_counts(fe: torch.Tensor, e: int) -> torch.Tensor:
    """Pairs routed to each of ``e`` experts, int64 ``(e,)``: the integers of
    ``torch.bincount(fe, minlength=e)``, counted where ``fe`` lies without
    reading its maximum on the host (``bincount`` sizes its output from it,
    a host sync that a captured CUDA graph cannot hold)."""
    return torch.zeros(e, dtype=torch.int64, device=fe.device).scatter_add_(
        0, fe, torch.ones_like(fe))


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """``(probs (T, E), top_i (T, k), top_g (T, k))``: the f32 router's
    probabilities, each token's k experts (most probable first, lower index
    first among equals) and their renormalized gates."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    top_g = probs.gather(1, top_i)
    return probs, top_i, top_g / top_g.sum(dim=-1, keepdim=True).clamp_min(1e-9)


def moe_mlp(x: torch.Tensor, p: dict, cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, d)`` -> ``(output (B, S, d), aux loss scalar)``."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    cap = moe_capacity(t, cfg)
    xt = x.reshape(t, d)
    dev = x.device
    probs, top_i, top_g = route(xt, p["router"], k)

    # load-balancing aux loss (Switch): E · Σ_e f_e · P_e
    fe = top_i.reshape(-1)  # (T·k,) expert of each pair
    counts = expert_counts(fe, e)
    aux = e * (probs.mean(dim=0) * (counts.float() / (t * k))).sum()

    order = torch.sort(fe, stable=True).indices
    se = fe[order]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - starts[se]
    slot = torch.where(rank < cap, se * cap + rank, e * cap)  # overflow -> scratch slot
    # slot -> source token; unfilled slots read the zero row t
    slot_tok = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    slot_tok[slot] = torch.arange(t, device=dev).repeat_interleave(k)[order]
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    buf = xt_pad[slot_tok[: e * cap]].reshape(e, cap, d)

    gate = F.silu(L.matmul(buf, p["w_gate_e"]).float())
    up = L.matmul(buf, p["w_up_e"]).float()
    out_e = L.matmul((gate * up).to(x.dtype), p["w_down_e"])  # (E, C, d)

    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot  # back to pair order
    flat = torch.cat([out_e.reshape(e * cap, d), out_e.new_zeros((1, d))])
    per_pair = flat[pair_slot].reshape(t, k, d)
    yt = (per_pair.float() * top_g[..., None]).sum(dim=1)
    if cfg.n_shared:
        yt = yt + L.swiglu_mlp(xt, p["shared"]).float()
    return yt.to(x.dtype).reshape(b, s, d), aux

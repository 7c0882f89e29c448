"""The Mamba-2 (SSD, state-space duality) block (counterpart of
``repro/models/ssm.py``).

The chunked SSD algorithm of Dao & Gu (2024): within a chunk of ``Q``
positions the state-space kernel is a masked product (``C_i · B_j`` times
the decay ``exp(segsum)`` between ``j`` and ``i``, times ``x_j``); across
chunks a linear recurrence carries the ``(H, P, N)`` state.  Prefill runs
the chunked form, decode the O(1) recurrent update.  The reference
computes both in jnp einsums and ``lax.scan``, outside any Pallas kernel,
so they stay plain PyTorch here; the recurrence over chunks is a Python
loop over the chunks.  ``exp(segsum)`` keeps ``-inf`` above the diagonal,
in f32, so the decay of a later position onto an earlier one is exactly 0.

Layout: ``d_inner = expand · d_model``, ``H = d_inner / head_dim`` heads,
state size ``N``, B and C shared by the heads of a group (``n_groups``).
``w_in`` packs ``[z, x, B, C, dt]``; ``w_in`` and ``w_out`` go through
``layers.matmul``, so they run the ``nm_spmm`` kernel on compressed
leaves.  The short depthwise conv (``conv_w``) and the recurrence
parameters ``a_log``, ``d_skip`` and ``dt_bias`` (f32) stay dense: the
sparsity config excludes them.

Over a model axis of ``S`` ranks (an active mesh, ``kernels.sharded``)
the state's heads split as the reference places them (``cache_pspecs``:
``(B, H, P, N)`` with H on ``model``): ``w_in`` (reduction-sharded, its
packed output whole) gives every rank the whole ``(z, xBC, dt)`` and the
conv, each rank runs the SSD scan and the recurrent step on its ``H/S``
heads alone (B and C, shared by a group's heads, go to each of them),
and ``w_out``, reduction-sharded over exactly those heads' ``y``
columns, takes the rank's ``y`` with no gather
(``layers.matmul_own``).  With heads that do not split the state is whole
on every rank and so is the scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import sharded
from repro_torch.models.layers import matmul, matmul_own


def ssm_dims(d_model: int, cfg: SSMConfig) -> dict:
    """``d_inner``, ``n_heads``, ``d_in_proj`` (``w_in``'s width) and
    ``conv_dim`` (the conv's channels: x, B and C)."""
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    gs = 2 * cfg.n_groups * cfg.d_state
    return dict(d_inner=d_inner, n_heads=n_heads, d_in_proj=2 * d_inner + gs + n_heads,
                conv_dim=d_inner + gs)


def held_heads(n_heads: int, shards: int) -> int:
    """The state heads a rank holds over ``shards`` model-axis ranks: its
    share where they split evenly, else all of them."""
    return n_heads // shards if shards > 1 and n_heads % shards == 0 else n_heads


def own_heads(n_heads: int) -> tuple[int, int]:
    """``[h0, h1)``: the heads this rank runs under the active mesh (all
    of them without one, or where they do not split)."""
    mesh = sharded.split_mesh()
    if mesh is None or held_heads(n_heads, mesh.model) == n_heads:
        return 0, n_heads
    return sharded.own_range(n_heads, mesh)


def _heads_in(x, dt, b, c, p: dict, h0: int, h1: int, n_heads: int):
    """The inputs of heads ``[h0, h1)``: x ``(B, S, H, P)`` and dt ``(B, S,
    H)`` sliced, B and C ``(B, S, G, N)`` given to each of those heads (one
    group each), and their ``a_log``, ``d_skip``, ``dt_bias``."""
    if (h0, h1) == (0, n_heads):
        return x, dt, b, c, p["a_log"], p["d_skip"], p["dt_bias"]
    rep = n_heads // b.shape[-2]
    b = b.repeat_interleave(rep, dim=-2)[..., h0:h1, :]
    c = c.repeat_interleave(rep, dim=-2)[..., h0:h1, :]
    return (x[..., h0:h1, :], dt[..., h0:h1], b, c, p["a_log"][h0:h1], p["d_skip"][h0:h1],
            p["dt_bias"][h0:h1])


def _out_proj(y: torch.Tensor, w, whole: bool):
    """``w_out`` over ``y``: all heads' columns, or this rank's heads'."""
    return matmul(y, w) if whole else matmul_own(y, w)


def _split_in_proj(zxbcdt: torch.Tensor, d_model: int, cfg: SSMConfig):
    """``w_in``'s output -> ``(z, xBC, dt)``."""
    dims = ssm_dims(d_model, cfg)
    di, cd = dims["d_inner"], dims["conv_dim"]
    return zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S, then SiLU in f32, back to ``xbc``'s
    dtype.  xbc: (B, S, C), conv_w: (W, C)."""
    w, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + s] * conv_w[i] for i in range(w))
    return F.silu(out.float()).to(xbc.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``segsum(x)[..., i, j] = sum_{k=j+1..i} x[..., k]`` on and below the
    diagonal, ``-inf`` above.  x: (..., Q) -> (..., Q, Q)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, init_state=None):
    """The chunked SSD scan.  x (B, S, H, P); dt (B, S, H), softplus'd; a_log
    (H,); b, c (B, S, G, N); ``init_state`` (B, H, P, N) or None.  Returns
    ``(y (B, S, H, P), final state (B, H, P, N))``, both f32."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the length {s}")
    nc, rep = s // chunk, h // g
    xc = (x * dt[..., None]).float().reshape(bsz, nc, chunk, h, p)  # dt-weighted input
    dac = (dt.float() * -torch.exp(a_log.float())).reshape(bsz, nc, chunk, h)  # <= 0
    bh = b.float().reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    ch = c.float().reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    # within a chunk: y_i = sum_j C_i . B_j exp(segsum)_ij x_j
    decay = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))  # (B, nc, H, Q, Q)
    scores = torch.einsum("bzqhn,bzkhn->bzhqk", ch, bh)
    y = torch.einsum("bzhqk,bzkhp->bzqhp", scores * decay, xc)
    del decay, scores

    # each chunk's state contribution and its total decay
    cum = torch.cumsum(dac, dim=2)  # (B, nc, Q, H)
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)
    states = torch.einsum("bzqh,bzqhn,bzqhp->bzhpn", decay_to_end, bh, xc)
    chunk_decay = torch.exp(cum[:, :, -1])  # (B, nc, H)

    # across chunks: the state entering chunk z, S_{z+1} = decay_z S_z + states_z
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entering = []
    for z in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, z, :, None, None] + states[:, z]
    s_enter = torch.stack(entering, dim=1)  # (B, nc, H, P, N)

    # the state entering the chunk, seen from each position: C_i exp(cum_i) S
    y = y + torch.einsum("bzqhn,bzqh,bzhpn->bzqhp", ch, torch.exp(cum), s_enter)
    return y.reshape(bsz, s, h, p), state


def ssm_block(u: torch.Tensor, p: dict, d_model: int, cfg: SSMConfig, init_state=None):
    """The Mamba-2 mixer over ``u`` (B, S, d_model).  Returns ``(out (B, S,
    d_model), (ssm state (B, H, P, N) f32, conv tail))``, the tail the last
    ``conv_width - 1`` positions of ``w_in``'s xBC (fewer for a shorter
    prompt: the cache write left-pads it with zeros).  The chunk is the
    largest divisor of S not above ``cfg.chunk``, the reference's rule."""
    dims = ssm_dims(d_model, cfg)
    di, nh = dims["d_inner"], dims["n_heads"]
    g, n, hd = cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xbc_raw, dt = _split_in_proj(matmul(u, p["w_in"]), d_model, cfg)
    conv_tail = xbc_raw[:, -(cfg.conv_width - 1):]
    xbc = _causal_conv(xbc_raw, p["conv_w"])
    bsz, s, _ = u.shape
    h0, h1 = own_heads(nh)
    x, dt, b, c, a_log, d_skip, dt_bias = _heads_in(
        xbc[..., :di].reshape(bsz, s, nh, hd), dt, xbc[..., di:di + g * n].reshape(bsz, s, g, n),
        xbc[..., di + g * n:].reshape(bsz, s, g, n), p, h0, h1, nh)
    dt = F.softplus(dt.float() + dt_bias)  # (B, S, H)
    chunk = min(cfg.chunk, s)
    while s % chunk:
        chunk -= 1
    y, s_final = ssd_chunked(x, dt, a_log, b, c, chunk, init_state)
    y = y + d_skip[:, None] * x.float()
    y = y.reshape(bsz, s, (h1 - h0) * hd) * F.silu(z[..., h0 * hd:h1 * hd].float())  # gated
    return _out_proj(y.to(u.dtype), p["w_out"], h1 - h0 == nh), (s_final, conv_tail)


def ssm_decode_step(u: torch.Tensor, p: dict, d_model: int, cfg: SSMConfig,
                    ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One token per lane, the O(1) recurrent update: u (B, 1, d_model),
    ssm_state (B, H, P, N) f32, conv_state (B, W - 1, conv_dim).  Returns
    ``(out (B, 1, d_model), new ssm_state, new conv_state)``."""
    dims = ssm_dims(d_model, cfg)
    di, nh = dims["d_inner"], dims["n_heads"]
    g, n, hd = cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xbc, dt = _split_in_proj(matmul(u, p["w_in"]), d_model, cfg)
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B, W, C)
    conv_w = p["conv_w"]
    conv = sum(full[:, i:i + 1] * conv_w[i] for i in range(conv_w.shape[0]))
    xbc1 = F.silu(conv.float()).to(u.dtype)
    h0, h1 = own_heads(nh)
    x, dt, b, c, a_log, d_skip, dt_bias = _heads_in(
        xbc1[:, 0, :di].reshape(-1, nh, hd).float(), dt[:, 0],
        xbc1[:, 0, di:di + g * n].reshape(-1, g, n), xbc1[:, 0, di + g * n:].reshape(-1, g, n),
        p, h0, h1, nh)  # x (B, H, P)
    rep = (h1 - h0) // b.shape[1]
    b = b.float().repeat_interleave(rep, dim=1)
    c = c.float().repeat_interleave(rep, dim=1)
    dt1 = F.softplus(dt.float() + dt_bias)  # (B, H)
    da = torch.exp(dt1 * -torch.exp(a_log.float()))
    new_state = (ssm_state * da[..., None, None]
                 + torch.einsum("bhn,bhp,bh->bhpn", b, x, dt1))
    y = torch.einsum("bhpn,bhn->bhp", new_state, c) + d_skip[:, None] * x
    y = y.reshape(-1, 1, (h1 - h0) * hd) * F.silu(z[..., h0 * hd:h1 * hd].float())
    return _out_proj(y.to(u.dtype), p["w_out"], h1 - h0 == nh), new_state, full[:, 1:]

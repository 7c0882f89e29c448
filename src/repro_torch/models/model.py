"""The decoder LM, dense family (counterpart of ``repro/models/model.py``).

Parameters are a nested dict keyed like the reference (``embed/tok_embed``,
``final/norm_scale``, ``body/sb_0/attn/wq``, ...), with the ``L`` layers
stacked along a leading axis of every ``body`` leaf, so a JAX tree carries
over as it is.  Leaves may be ``CompressedTensor``: every weight matmul goes
through ``layers.matmul``, so prefill and decode run on the compressed
artifact directly.

The cache is a dict ``{"len": (B,) int32, "body": {"sb_0": {"k", "v"}},
"tables": {...}}`` (tables only on the paged layout), updated in place.
On the paged layout decode attention goes through the ``paged_attn``
kernel, where the reference's kernel route does (``model.py:794-815``).

Only what gpt2-paper uses is ported: MHA/GQA attention with RoPE and
optional q/k/v/o biases, a GeLU MLP, LayerNorm and tied embeddings.  Other families
and options raise (ROADMAP.md lists them).  :func:`loss_fn` is the training
loss; it differentiates through :func:`forward` with autograd, which keeps
every layer's activations (the reference rematerializes them per layer; at
gpt2-paper's size and the training batches used here they fit).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attn import paged_attn
from repro_torch.models import layers as L
from repro_torch.models.cache import SlabLayout
from repro_torch.sparse_infer.compress import CompressedTensor
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    head: tuple[str, ...]  # unscanned leading layers (none in the dense family)
    period: tuple[str, ...]  # the stacked super-block's kinds
    n_body: int  # number of stacked super-blocks
    tail: tuple[str, ...]


def layer_plan(cfg: ArchConfig) -> LayerPlan:
    """The dense family's plan: one ``attn`` block stacked ``n_layers``
    times under ``body/sb_0``.  Raises for what is not ported."""
    unported = {
        "family": cfg.family != "dense", "norm": cfg.norm != "ln",
        "mlp": cfg.mlp != "gelu", "rope": cfg.rope != "rope",
        "local_window": cfg.local_window is not None,
        "untied embeddings": not cfg.tie_embeddings,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported to repro_torch yet "
            "(see ROADMAP.md)"
        )
    return LayerPlan((), ("attn",), cfg.n_layers, ())


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's shapes, dtypes and
    distributions (not its PRNG bits: parity tests carry weights over)."""
    plan = layer_plan(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d, f = plan.n_body, cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def dense(i, o):
        return normal((n, i, o), (2.0 / (i + o)) ** 0.5)

    def norm(*lead):
        return {"norm_scale": torch.ones(lead + (d,), device=dev),
                "norm_bias": torch.zeros(lead + (d,), device=dev)}

    attn = {"wq": dense(d, h * hd), "wk": dense(d, kv * hd),
            "wv": dense(d, kv * hd), "wo": dense(h * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bias_q", h * hd), ("bias_k", kv * hd), ("bias_v", kv * hd)):
            attn[name] = torch.zeros((n, width), dtype=dtype, device=dev)
    if cfg.o_bias:
        attn["bias_o"] = torch.zeros((n, d), dtype=dtype, device=dev)
    block = {"pre": norm(n), "attn": attn, "post": norm(n),
             "mlp": {"w_fc": dense(d, f), "w_proj": dense(f, d)}}
    params = {"embed": {"tok_embed": normal((cfg.vocab, d), 0.02)},
              "final": norm(), "body": {"sb_0": block}}
    return params


def _layers(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked sub-tree, as views.  ``unbind`` makes
    them in one op, whose backward stacks the per-layer gradients once."""
    per_leaf = {
        k: _layers(v, n) if isinstance(v, dict)
        else [v.layer(i) for i in range(n)] if isinstance(v, CompressedTensor)
        else v.unbind(0)
        for k, v in tree.items()
    }
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked sub-tree, as views."""
    return {
        k: _layer(v, i) if isinstance(v, dict)
        else v.layer(i) if isinstance(v, CompressedTensor) else v[i]
        for k, v in tree.items()
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _qkv(x, p, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    q, k, v = L.matmul(x, p["wq"]), L.matmul(x, p["wk"]), L.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bias_q"], k + p["bias_k"], v + p["bias_v"]
    q = L.apply_rope(q.reshape(b, s, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, s, cfg.n_kv, cfg.hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv, cfg.hd)


def _out(attn, p, cfg: ArchConfig):
    b, s = attn.shape[:2]
    out = L.matmul(attn.reshape(b, s, cfg.n_heads * cfg.hd), p["wo"])
    return out + p["bias_o"] if cfg.o_bias else out


def _mlp(x, p):
    return x + L.gelu_mlp(L.layernorm(x, p["post"]["norm_scale"], p["post"]["norm_bias"]),
                          p["mlp"])


def _unembed(x, params):
    """Tied logits ``norm(x) @ tok_embed.T``; the embedding stays dense."""
    x = L.layernorm(x, params["final"]["norm_scale"], params["final"]["norm_bias"])
    return x @ params["embed"]["tok_embed"].T


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            want_cache: bool = False, chunk: int = 512):
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V), caches).

    With ``want_cache`` the caches are ``{"body": {"sb_0": (k, v)}}``, each
    ``(L, B, S, Hkv, D)`` after RoPE — what ``write_prefill`` stores."""
    plan = layer_plan(cfg)
    b, s = tokens.shape
    x = params["embed"]["tok_embed"][tokens]
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    ks, vs = [], []
    for p in _layers(params["body"]["sb_0"], plan.n_body):
        h = L.layernorm(x, p["pre"]["norm_scale"], p["pre"]["norm_bias"])
        q, k, v = _qkv(h, p["attn"], cfg, positions)
        x = _mlp(x + _out(L.chunked_attention(q, k, v, chunk=chunk), p["attn"], cfg), p)
        if want_cache:
            ks.append(k)
            vs.append(v)
    logits = _unembed(x, params)
    caches = {"body": {"sb_0": (torch.stack(ks), torch.stack(vs))}} if want_cache else None
    return logits, caches


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *, chunk: int = 512,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """Training loss: ``(total, {"ce", "aux", "zloss"})``.

    Cross-entropy from an f32 logsumexp, plus ``z_weight·lse²`` and
    ``aux_weight·aux`` (the dense family has no auxiliary loss: 0), each a
    mean over the tokens, or over ``batch["loss_mask"]`` where given.
    ``batch`` holds ``tokens`` and ``labels`` (B, S)."""
    logits, _ = forward(params, cfg, batch["tokens"], chunk=chunk)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, batch["labels"].long()[..., None])[..., 0]
    nll, zloss = lse - ll, lse.square()
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.float()
        denom = mask.sum().clamp_min(1.0)
        ce, zl = (nll * mask).sum() / denom, (zloss * mask).sum() / denom
    else:
        ce, zl = nll.mean(), zloss.mean()
    aux = torch.zeros((), device=lf.device)
    total = ce + aux_weight * aux + z_weight * zl
    return total, {"ce": ce, "aux": aux, "zloss": zl}


# ---------------------------------------------------------------------------
# serving cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, dtype=None,
               layout=None, device="cuda") -> dict:
    """Allocate the decode cache; ``layout`` defaults to a slab."""
    plan = layer_plan(cfg)
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    layout = layout or SlabLayout(max_len)
    cache = {
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        "body": {"sb_0": layout.attn_alloc(plan.n_body, batch_size, cfg.n_kv,
                                           cfg.hd, dtype, dev)},
    }
    tables = layout.tables(batch_size, dev)
    if tables is not None:
        cache["tables"] = tables
    return cache


def write_prefill(cache: dict, cfg: ArchConfig, produced: dict, lanes, lens,
                  layout=None) -> dict:
    """Store freshly prefilled rows: row ``r`` of ``produced`` (from
    ``forward(want_cache=True)``), valid below ``lens[r]``, lands in lane
    ``lanes[r]``.  Every row is a real request (the engine drops its pad
    rows before this call); lanes are distinct."""
    layout = layout or SlabLayout(cache["body"]["sb_0"]["k"].shape[2])
    k, v = produced["body"]["sb_0"]
    layout.attn_write_rows(cache["body"]["sb_0"], k, v, lanes, lens, cache.get("tables"))
    cache["len"][lanes] = lens.to(torch.int32)
    return cache


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                cache: dict, layout=None):
    """One serving step: tokens (B,) -> (logits (B, V), cache).

    Every lane writes its token at ``cache["len"]`` and attends over
    ``len + 1`` positions; ``cache["len"]`` then advances by one.  The cache
    is updated in place and returned."""
    plan = layer_plan(cfg)
    layout = layout or SlabLayout(cache["body"]["sb_0"]["k"].shape[2])
    b = tokens.shape[0]
    pos = cache["len"]
    tables = cache.get("tables")
    x = params["embed"]["tok_embed"][tokens][:, None, :]
    g = cfg.n_heads // cfg.n_kv
    for i in range(plan.n_body):
        p = _layer(params["body"]["sb_0"], i)
        c = _layer(cache["body"]["sb_0"], i)
        h = L.layernorm(x, p["pre"]["norm_scale"], p["pre"]["norm_bias"])
        q, k, v = _qkv(h, p["attn"], cfg, pos[:, None])
        layout.attn_write(c, k[:, 0], v[:, 0], pos, tables)
        if layout.kind == "paged":
            attn = paged_attn(
                q[:, 0].reshape(b, cfg.n_kv, g, cfg.hd).contiguous(),
                layout.pool_view(c["k"]), layout.pool_view(c["v"]),
                tables["full"], pos + 1, scale=cfg.hd ** -0.5,
            ).reshape(b, 1, cfg.n_heads, cfg.hd)
        else:
            s_view = c["k"].shape[1]
            attn = L.decode_attention(q, c["k"], c["v"], pos.clamp(max=s_view - 1) + 1)
        x = _mlp(x + _out(attn, p["attn"], cfg), p)
    cache["len"] = pos + 1
    return _unembed(x, params)[:, 0], cache


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, max_len: int):
    """Prompt (B, S) -> (last logits (B, V), a fresh slab cache holding it)."""
    logits, produced = forward(params, cfg, tokens, want_cache=True)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    lanes = torch.arange(b, device=tokens.device)
    write_prefill(cache, cfg, produced, lanes,
                  torch.full((b,), s, dtype=torch.int32, device=tokens.device))
    return logits[:, -1], cache

"""The decoder LM (counterpart of ``repro/models/model.py``).

Parameters are a nested dict keyed like the reference (``embed/tok_embed``,
``final/norm_scale``, ``head_0/attn/w_q``, ``body/sb_0/moe/w_gate_e``, ...).
``layer_plan`` splits the layers as the reference does: unstacked leading
``head_*`` layers (DeepSeek's dense first layer), then ``n_body`` copies of
a period of blocks, block ``j`` of the period stacked along a leading axis
of every ``body/sb_j`` leaf, then unstacked trailing ``tail_*`` layers
(RecurrentGemma's 38 = 12 x (rec, rec, attn) + 2), so a JAX tree carries
over as it is.  Leaves may be ``CompressedTensor``: every weight matmul
goes through ``layers.matmul``, so prefill and decode run on the
compressed artifact directly (MoE expert stacks in one batched launch per
weight).

The cache is a dict ``{"len": (B,) int32, "head_0": {...}, "body": {"sb_0":
{...}, ...}, "tail_0": {...}, "tables": {...}}`` (tables only on the paged
layout; empty for an arch without attention) whose entries are ``{"k",
"v"}`` for attention, ``{"ckv", "krope"}`` for MLA and ``{"state",
"conv"}`` for RG-LRU and SSM layers, updated in place.  Attention and MLA
entries live in the layout (slab or pages); recurrent states are per lane
under both.  On the paged layout decode attention goes
through the ``paged_attn`` kernel where the reference's kernel route does:
the MHA/GQA form for attention (``model.py:794-815``; over the modular
window table, K2w, for sliding-window layers), the MLA latent form (K2m)
for MLA (``mla.py:202-237``); on an int8 pool (``PagedLayout.quant``) each
with its scale planes (K2q).  :func:`prefill_chunk` absorbs one prompt
chunk of several lanes at once into that cache (chunked prefill and a
prefix hit's uncached tail), every projection through ``layers.matmul``.

Tensor-parallel serving (the engine's ``mesh``, every family): each rank
holds its shard of the compressed matmul weights (``layers.matmul``
combines them: output-sharded leaves gather, reduction-sharded ones and
MoE expert stacks sum) and of the vocab-sharded ``tok_embed`` (the lookup
is masked to the rank's rows and summed, the tied unembedding computes
the rank's vocab slice of the logits and gathers them), and its share of
the cache: its page range of the pool, on which decode attention runs
the stats form of the kernel (K3: GQA, window and MLA forms) and combines
the ranks' partial softmaxes (``kernels.sharded.paged_attn_sharded``), or
its rows of every lane of the slab (``SlabLayout.shards``), combined the
same way.  MLA's absorbed decode computes the latent queries of the
rank's heads and gathers them (``mla.py``); an SSM layer runs its state's
heads on the rank that holds them (``ssm.py``), and an RG-LRU layer on the
split slab its state's columns (``recurrent.py``; on a pool its state is
whole on every rank, as the reference places it).  Activations, logits,
tables and lengths are replicated, so every rank computes the same
tokens.

Ported: every family of the reference.  The dense family (MHA/GQA
attention with RoPE, optional q/k/v/o biases and a sliding window), the
MoE family with MLA (DeepSeek-V2) or GQA attention (DBRX), the SSM family
of Mamba-2 blocks (a mixer and no MLP; ``models.ssm``), the hybrid family
of RG-LRU and local-attention blocks (RecurrentGemma), and the ``vlm`` and
``audio`` families: dense attention stacks whose batch may carry stub
frontend embeddings (``embeds`` (B, S, :func:`frontend_dim`), projected
by ``frontend/frontend_proj``, a maskable matmul weight) in place of
tokens.  RoPE or M-RoPE (Qwen2-VL: three position streams, (B, S, 3));
the chunk and decode routes give M-RoPE one position broadcast over its
three streams, as the reference does.  SwiGLU and GeLU MLPs, RMSNorm and
LayerNorm, tied and untied embeddings.  Hybrid patterns with SSM blocks
and windows on MLA raise.
:func:`loss_fn` is the training loss; it differentiates through the
forward with autograd, which keeps every layer's activations (the
reference rematerializes them per layer).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import sharded
from repro_torch.kernels.paged_attn import paged_attn
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as REC
from repro_torch.models import ssm as SSM
from repro_torch.models.cache import SlabLayout
from repro_torch.sparse_infer.compress import CompressedTensor
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    head: tuple[str, ...]  # kinds of unstacked leading layers
    period: tuple[str, ...]  # the stacked super-block's kinds
    n_body: int  # number of stacked super-blocks
    tail: tuple[str, ...]


def layer_plan(cfg: ArchConfig) -> LayerPlan:
    """The reference's plan: a ``head_0`` with a dense MLP where the MoE
    config asks for one; the layer pattern's period stacked ``n_body``
    times under ``body/sb_j`` (one kind without a pattern); the layers
    left over as ``tail_*``.  Raises for what is not ported."""
    pattern = set(cfg.layer_pattern or ())
    ssm = cfg.family == "ssm"
    unported = {
        "family": cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"),
        "rope": cfg.rope not in (("none",) if ssm else ("rope", "mrope")),
        "ssm family without an ssm config, or with a layer_pattern": ssm and (
            cfg.ssm is None or bool(pattern)),
        "layer_pattern": not pattern <= {"rec", "attn"},
        "hybrid family without a rec/attn layer_pattern": (
            cfg.family == "hybrid" and not pattern),
        "rec layers without an rglru config": "rec" in pattern and cfg.rglru is None,
        "local_window on MLA": cfg.local_window is not None and cfg.mla is not None,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: {', '.join(bad)} not supported")
    kinds = cfg.block_kinds()
    head: tuple[str, ...] = ()
    if cfg.moe is not None and cfg.moe.first_layer_dense:
        head, kinds = (kinds[0] + ":dense",), kinds[1:]
    if cfg.layer_pattern is None:
        return LayerPlan(head, (kinds[0],), len(kinds), ())
    p = len(cfg.layer_pattern)
    n_body = len(kinds) // p
    return LayerPlan(head, tuple(cfg.layer_pattern), n_body, tuple(kinds[n_body * p:]))


def _groups(plan: LayerPlan) -> list[tuple[tuple[str, ...], str, int]]:
    """Every layer group of the tree in order: ``(path, kind, stack)``,
    ``stack`` the number of stacked layers (0 for an unstacked layer)."""
    return ([((f"head_{i}",), kind, 0) for i, kind in enumerate(plan.head)]
            + [(("body", f"sb_{j}"), kind, plan.n_body)
               for j, kind in enumerate(plan.period) if plan.n_body]
            + [((f"tail_{i}",), kind, 0) for i, kind in enumerate(plan.tail)])


def _at(tree: dict, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def check_mesh(cfg: ArchConfig, mesh) -> None:
    """Raise for what tensor-parallel serving does not run yet: a data axis
    of more than one rank (lanes over the data axis are part of the rest
    of tensor parallelism, ROADMAP.md).  Every family serves over a model
    axis."""
    if mesh is not None and mesh.data > 1:
        raise NotImplementedError(
            f"{cfg.name}: a data axis > 1 is not ported yet (the rest of tensor parallelism, "
            "ROADMAP.md)")


def _block_mixer_mlp(kind: str, cfg: ArchConfig) -> tuple[str, str]:
    """A layer kind -> ``(mixer, mlp)``: ``attn | mla | ssm | rec`` and
    ``dense | moe | none`` (an SSM block is its mixer alone)."""
    base = kind.split(":")[0]
    if base == "ssm":
        return "ssm", "none"
    if base == "rec":
        return "rec", "dense"
    mixer = "mla" if cfg.mla is not None else "attn"
    moe = cfg.moe is not None and not kind.endswith(":dense")
    return mixer, ("moe" if moe else "dense")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's shapes, dtypes and
    distributions (not its PRNG bits: parity tests carry weights over).
    A stacked expert leaf is drawn one layer slice at a time, so the f32
    draws never hold more than one slice."""
    plan = layer_plan(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd

    def normal(shape, std, dt=dtype):
        out = torch.empty(shape, dtype=dt, device=dev)
        for part in (out.unbind(0) if len(shape) > 3 else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev) * std)
        return out

    def dense(lead, i, o):
        return normal(lead + (i, o), (2.0 / (i + o)) ** 0.5)

    def norm(*lead):
        if cfg.norm == "rms":
            return {"norm_scale": torch.zeros(lead + (d,), device=dev)}
        return {"norm_scale": torch.ones(lead + (d,), device=dev),
                "norm_bias": torch.zeros(lead + (d,), device=dev)}

    def attn(lead):
        if cfg.mla is not None:
            m = cfg.mla
            return {"w_q": dense(lead, d, h * (m.nope_head_dim + m.rope_head_dim)),
                    "w_dkv": dense(lead, d, m.kv_lora + m.rope_head_dim),
                    "w_ukv": dense(lead, m.kv_lora, h * (m.nope_head_dim + m.v_head_dim)),
                    "w_o": dense(lead, h * m.v_head_dim, d)}
        p = {"wq": dense(lead, d, h * hd), "wk": dense(lead, d, kv * hd),
             "wv": dense(lead, d, kv * hd), "wo": dense(lead, h * hd, d)}
        if cfg.qkv_bias:
            for name, width in (("bias_q", h * hd), ("bias_k", kv * hd), ("bias_v", kv * hd)):
                p[name] = torch.zeros(lead + (width,), dtype=dtype, device=dev)
        if cfg.o_bias:
            p["bias_o"] = torch.zeros(lead + (d,), dtype=dtype, device=dev)
        return p

    def swiglu(lead, f):
        return {"w_gate": dense(lead, d, f), "w_up": dense(lead, d, f),
                "w_down": dense(lead, f, d)}

    def moe(lead):
        m = cfg.moe
        e, f = m.n_experts, m.d_ff_expert
        scale_in = (2.0 / (d + f)) ** 0.5  # the reference's, for all three stacks
        p = {"router": normal(lead + (d, e), 0.02, torch.float32),
             "w_gate_e": normal(lead + (e, d, f), scale_in),
             "w_up_e": normal(lead + (e, d, f), scale_in),
             "w_down_e": normal(lead + (e, f, d), scale_in)}
        if m.n_shared:
            p["shared"] = swiglu(lead, m.n_shared * f)
        return p

    def rglru(lead):
        w, cw = cfg.rglru.lru_width, cfg.rglru.conv_width
        lam = torch.log(torch.expm1(torch.linspace(0.9, 0.999, w, device=dev)))
        return {"w_x": dense(lead, d, w), "w_gate_branch": dense(lead, d, w),
                "w_out": dense(lead, w, d), "conv_w": normal(lead + (cw, w), 0.1),
                "w_a_gate": dense(lead, d, w), "w_i_gate": dense(lead, d, w),
                "a_log_lambda": lam.expand(lead + (w,)).contiguous()}

    def ssm(lead):
        dims = SSM.ssm_dims(d, cfg.ssm)
        a_log = torch.log(torch.linspace(1.0, 16.0, dims["n_heads"], device=dev))
        return {"w_in": dense(lead, d, dims["d_in_proj"]),
                "w_out": dense(lead, dims["d_inner"], d),
                "conv_w": normal(lead + (cfg.ssm.conv_width, dims["conv_dim"]), 0.1),
                "a_log": a_log.expand(lead + a_log.shape).contiguous(),
                "d_skip": torch.ones(lead + a_log.shape, device=dev),
                "dt_bias": torch.zeros(lead + a_log.shape, device=dev)}

    def block(kind, lead):
        mixer, mlp = _block_mixer_mlp(kind, cfg)
        p = {"pre": norm(*lead)}
        if mlp != "none":
            p["post"] = norm(*lead)
        if mixer == "rec":
            p["mixer"] = rglru(lead)
        elif mixer == "ssm":
            p["mixer"] = ssm(lead)
        else:
            p["attn"] = attn(lead)
        if mlp == "moe":
            p["moe"] = moe(lead)
        elif mlp == "dense" and cfg.mlp == "swiglu":
            p["mlp"] = swiglu(lead, cfg.d_ff)
        elif mlp == "dense":
            p["mlp"] = {"w_fc": dense(lead, d, cfg.d_ff), "w_proj": dense(lead, cfg.d_ff, d)}
        return p

    params: dict = {}
    for path, kind, stack in _groups(plan):
        _put(params, path, block(kind, (stack,) if stack else ()))
    params["embed"] = {"tok_embed": normal((cfg.vocab, d), 0.02)}
    params["final"] = norm()
    if not cfg.tie_embeddings:
        params["unembed"] = {"out_embed": dense((), d, cfg.vocab)}
    if cfg.frontend != "none":
        params["frontend"] = {"frontend_proj": dense((), frontend_dim(cfg), d)}
    return params


def frontend_dim(cfg: ArchConfig) -> int:
    """Width of a stub frontend's embeddings: 512 for audio frames, 1176
    for vision patches (14 x 14 x 2 frames x 3 channels); 0 without one."""
    return {"audio_stub": 512, "vision_stub": 1176}.get(cfg.frontend, 0)


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


def _apply_norm(cfg: ArchConfig, p: dict, x):
    if cfg.norm == "rms":
        return L.rmsnorm(x, p["norm_scale"])
    return L.layernorm(x, p["norm_scale"], p["norm_bias"])


def _qkv(x, p, cfg: ArchConfig, positions):
    """Projections and rotary embedding; ``positions`` (B, S), or (B, S, 3)
    streams under M-RoPE, where a (B, S) position goes to all three."""
    b, s, _ = x.shape
    q, k, v = L.matmul(x, p["wq"]), L.matmul(x, p["wk"]), L.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bias_q"], k + p["bias_k"], v + p["bias_v"]
    q, k = q.reshape(b, s, cfg.n_heads, cfg.hd), k.reshape(b, s, cfg.n_kv, cfg.hd)
    if cfg.rope == "mrope":
        if positions.dim() == 2:
            positions = positions[..., None].expand(b, s, 3)
        q = L.apply_mrope(q, positions, theta=cfg.rope_theta)
        k = L.apply_mrope(k, positions, theta=cfg.rope_theta)
    else:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv, cfg.hd)


def _out(attn, p, cfg: ArchConfig):
    b, s = attn.shape[:2]
    out = L.matmul(attn.reshape(b, s, cfg.n_heads * cfg.hd), p["wo"])
    return out + p["bias_o"] if cfg.o_bias else out


def _mlp(x, p, kind: str, cfg: ArchConfig):
    """The residual MLP half of a block: ``(x + mlp(norm(x)), aux loss)``;
    ``(x, 0)`` for a block without one (SSM)."""
    mlp_kind = _block_mixer_mlp(kind, cfg)[1]
    if mlp_kind == "none":
        return x, 0.0
    h = _apply_norm(cfg, p["post"], x)
    if mlp_kind == "moe":
        out, aux = MOE.moe_mlp(h, p["moe"], cfg.moe)
        return x + out, aux
    mlp = L.swiglu_mlp if cfg.mlp == "swiglu" else L.gelu_mlp
    return x + mlp(h, p["mlp"]), 0.0


def _block_forward(x, p, kind: str, cfg: ArchConfig, positions, chunk: int):
    """Full-sequence block: ``(x, aux loss, cache entry)``, the entry
    ``(k, v)`` for attention (after RoPE), ``(c_kv, k_rope)`` for MLA,
    ``(lru_state, conv_tail)`` for RG-LRU and ``(ssm_state, conv_tail)``
    for SSM."""
    h = _apply_norm(cfg, p["pre"], x)
    mixer = _block_mixer_mlp(kind, cfg)[0]
    if mixer == "rec":
        mix, state, conv = REC.rglru_block(h, p["mixer"], cfg.rglru)
        entry = (state, conv)
    elif mixer == "ssm":
        mix, entry = SSM.ssm_block(h, p["mixer"], cfg.d_model, cfg.ssm)
    elif mixer == "mla":  # MLA's RoPE reads the first stream of 3-D positions
        pos1d = positions if positions.dim() == 2 else positions[..., 0]
        mix, entry = MLA.mla_attention(h, p["attn"], cfg.n_heads, cfg.mla, pos1d,
                                       cfg.rope_theta, chunk)
    else:
        q, k, v = _qkv(h, p["attn"], cfg, positions)
        attn = L.chunked_attention(q, k, v, window=cfg.local_window, chunk=chunk)
        mix, entry = _out(attn, p["attn"], cfg), (k, v)
    x, aux = _mlp(x + mix, p, kind, cfg)
    return x, aux, entry


def _attn_decode(x, p, cfg: ArchConfig, c: dict, pos, layout, tables, commit=None):
    b = x.shape[0]
    q, k, v = _qkv(x, p, cfg, pos[:, None])
    layout.write(c, {"k": k[:, 0], "v": v[:, 0]}, pos, tables, window=cfg.local_window,
                 commit=commit)
    if layout.kind == "paged":
        g = cfg.n_heads // cfg.n_kv
        win = layout.view_window(cfg.local_window)
        scales = ({f"{n}_scale": layout.pool_view(c[f"{n}_scale"]) for n in ("k", "v")}
                  if layout.quant else {})
        kernel = sharded.paged_attn_sharded if layout.shards > 1 else paged_attn
        attn = kernel(
            q[:, 0].reshape(b, cfg.n_kv, g, cfg.hd).contiguous(),
            layout.pool_view(c["k"]), layout.pool_view(c["v"]),
            tables[layout.table_key(cfg.local_window)], pos + 1, scale=cfg.hd ** -0.5,
            window=win, win_slots=layout.pages_win if win else 0, **scales,
        ).reshape(b, 1, cfg.n_heads, cfg.hd)
    elif layout.split(cfg.local_window) > 1:  # this rank's rows of the slab, then the combine
        valid = layout.valid_rows(pos, c["k"].shape[1], cfg.local_window)
        acc, m, l = L.decode_attention_stats(q, c["k"], c["v"], valid)
        attn = sharded.combine_stats(acc, m, l).to(q.dtype).reshape(b, 1, cfg.n_heads, cfg.hd)
    else:
        s_view = c["k"].shape[1]
        attn = L.decode_attention(q, c["k"], c["v"], pos.clamp(max=s_view - 1) + 1)
    return _out(attn, p, cfg)


def _block_decode(x, p, kind: str, cfg: ArchConfig, c: dict, pos, layout, tables,
                  commit=None):
    h = _apply_norm(cfg, p["pre"], x)
    mixer = _block_mixer_mlp(kind, cfg)[0]
    if mixer in ("rec", "ssm"):
        if mixer == "rec":
            mix, state, conv = REC.rglru_decode_step(h, p["mixer"], cfg.rglru, c["state"],
                                                     c["conv"])
        else:
            mix, state, conv = SSM.ssm_decode_step(h, p["mixer"], cfg.d_model, cfg.ssm,
                                                   c["state"], c["conv"])
        for name, new in (("state", state), ("conv", conv)):
            if commit is not None:  # lanes outside commit keep their state
                new = torch.where(commit.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                                  c[name])
            c[name].copy_(new)
    elif mixer == "mla":
        mix = MLA.mla_decode(h, p["attn"], cfg.n_heads, cfg.mla, c, pos, cfg.rope_theta,
                             layout, tables)
    else:
        mix = _attn_decode(h, p["attn"], cfg, c, pos, layout, tables, commit)
    return _mlp(x + mix, p, kind, cfg)[0]


def _embed(params, cfg: ArchConfig, tokens):
    """Token embeddings; a rank's vocab shard of ``tok_embed`` (fewer rows
    than the vocab) looks up its own rows and sums over the ranks."""
    tok = params["embed"]["tok_embed"]
    if tok.shape[0] == cfg.vocab:
        return tok[tokens]
    return sharded.embed_sharded(tok, tokens)


def _unembed(x, params, cfg: ArchConfig):
    """Logits from the final norm: tied (``tok_embed.T``, dense; a vocab
    shard computes its slice of the logits and gathers) or through
    ``unembed/out_embed`` (left dense by the sparsity config)."""
    x = _apply_norm(cfg, params["final"], x)
    if cfg.tie_embeddings:
        tok = params["embed"]["tok_embed"]
        logits = x @ tok.T
        return logits if tok.shape[0] == cfg.vocab else sharded.all_gather(logits)
    return L.matmul(x, params["unembed"]["out_embed"])


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------


def _default_positions(cfg: ArchConfig, b: int, s: int, device):
    """Positions 0..s-1 of every row: (B, S), or (B, S, 3) under M-RoPE
    (the one position in all three streams)."""
    pos = torch.arange(s, device=device)[None, :].expand(b, s)
    return pos[..., None].expand(b, s, 3) if cfg.rope == "mrope" else pos


def _forward(params: dict, cfg: ArchConfig, batch, want_cache: bool, chunk: int):
    plan = layer_plan(cfg)
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    if "embeds" in batch and cfg.frontend != "none":
        x = L.matmul(batch["embeds"], params["frontend"]["frontend_proj"])
    else:
        x = _embed(params, cfg, batch["tokens"])
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, b, s, x.device)
    aux = torch.zeros((), device=x.device)
    caches: dict = {}
    for i, kind in enumerate(plan.head):
        x, a, caches[f"head_{i}"] = _block_forward(x, params[f"head_{i}"], kind, cfg,
                                                   positions, chunk)
        aux = aux + a
    if plan.n_body:
        stacks = [_layers(params["body"][f"sb_{j}"], plan.n_body)
                  for j in range(len(plan.period))]
        body: list[list] = [[] for _ in plan.period]
        for i in range(plan.n_body):
            for j, kind in enumerate(plan.period):
                x, a, entry = _block_forward(x, stacks[j][i], kind, cfg, positions, chunk)
                aux = aux + a
                if want_cache:
                    body[j].append(entry)
        caches["body"] = {f"sb_{j}": tuple(torch.stack(t) for t in zip(*entries))
                          for j, entries in enumerate(body) if entries}
    for i, kind in enumerate(plan.tail):
        x, a, caches[f"tail_{i}"] = _block_forward(x, params[f"tail_{i}"], kind, cfg,
                                                   positions, chunk)
        aux = aux + a
    return _unembed(x, params, cfg), aux, (caches if want_cache else None)


def forward(params: dict, cfg: ArchConfig, batch, *, want_cache: bool = False,
            chunk: int = 512):
    """Full-sequence forward: ``batch`` -> (logits (B, S, V), caches).

    ``batch`` is tokens (B, S), or the reference's batch: a dict of
    ``tokens`` (B, S), or of ``embeds`` (B, S, :func:`frontend_dim`) for an
    arch with a stub frontend, and optionally ``positions`` ((B, S), or
    (B, S, 3) under M-RoPE; 0..S-1 in every stream by default).

    With ``want_cache`` the caches hold each layer's cache entry over the
    whole prompt: ``{"head_0": (c_kv, k_rope), "body": {"sb_0": (...)},
    "tail_0": (...)}``, body entries stacked ``(L, B, ...)`` — what
    ``write_prefill`` stores.  RG-LRU entries are the final state and conv
    tail, so a prompt batch with recurrent layers must be of exact length
    (no pad tokens)."""
    logits, _, caches = _forward(params, cfg, batch, want_cache, chunk)
    return logits, caches


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *, chunk: int = 512,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """Training loss: ``(total, {"ce", "aux", "zloss"})``.

    Cross-entropy from an f32 logsumexp, plus ``z_weight·lse²`` and
    ``aux_weight·aux`` (the MoE load-balancing loss summed over layers; 0
    in the dense family), each a mean over the tokens, or over
    ``batch["loss_mask"]`` where given.  ``batch`` holds ``labels`` (B, S)
    and what :func:`forward` takes: ``tokens`` or ``embeds``, and
    optionally ``positions``."""
    logits, aux, _ = _forward(params, cfg, batch, False, chunk)
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
    total = ce + aux_weight * aux + z_weight * zl
    return total, {"ce": ce, "aux": aux, "zloss": zl}


# ---------------------------------------------------------------------------
# serving cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, dtype=None,
               layout=None, device="cuda") -> dict:
    """Allocate the decode cache; ``layout`` defaults to a slab.  RG-LRU
    layers get ``{"state": (B, W) f32, "conv": (B, conv_width - 1, W)}``
    and SSM layers ``{"state": (B, H, P, N) f32, "conv": (B, conv_width -
    1, conv_dim)}`` under either layout, the conv in ``dtype``."""
    plan = layer_plan(cfg)
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    layout = layout or SlabLayout(max_len)

    def alloc(kind, stack):
        lead, entries = (stack,) if stack else (), _cache_entries(kind, cfg, layout)
        if _block_mixer_mlp(kind, cfg)[0] in ("rec", "ssm"):
            return {name: torch.zeros(lead + (batch_size,) + shp, device=dev,
                                      dtype=torch.float32 if name == "state" else dtype)
                    for name, shp in entries.items()}
        return layout.alloc(lead, batch_size, entries, dtype, dev, window=cfg.local_window)

    cache = {"len": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}
    for path, kind, stack in _groups(plan):
        _put(cache, path, alloc(kind, stack))
    tables = layout.tables(batch_size, dev)
    if tables is not None:
        cache["tables"] = tables
    return cache


def _cache_entries(kind: str, cfg: ArchConfig, layout=None) -> dict:
    """A layer's cache leaves -> per-token (per-lane for RG-LRU and SSM)
    shape, in the order of the entry ``forward(want_cache=True)``
    produces.  Over a ``layout`` split across model-axis ranks an SSM
    state holds the rank's heads (``ssm.held_heads``), and on the split
    slab an RG-LRU state its columns (``recurrent.held_width``)."""
    mixer = _block_mixer_mlp(kind, cfg)[0]
    shards = layout.shards if layout is not None else 1
    if mixer == "rec":
        w = cfg.rglru.lru_width
        held = REC.held_width(w, shards) if layout is not None and layout.kind == "slab" else w
        return {"state": (held,), "conv": (cfg.rglru.conv_width - 1, w)}
    if mixer == "ssm":
        dims = SSM.ssm_dims(cfg.d_model, cfg.ssm)
        heads = SSM.held_heads(dims["n_heads"], shards)
        return {"state": (heads, cfg.ssm.head_dim, cfg.ssm.d_state),
                "conv": (cfg.ssm.conv_width - 1, dims["conv_dim"])}
    if mixer == "mla":
        return {"ckv": (cfg.mla.kv_lora,), "krope": (cfg.mla.rope_head_dim,)}
    return {"k": (cfg.n_kv, cfg.hd), "v": (cfg.n_kv, cfg.hd)}


def write_prefill(cache: dict, cfg: ArchConfig, produced: dict, lanes, lens,
                  layout=None) -> dict:
    """Store freshly prefilled rows: row ``r < len(lanes)`` of ``produced``
    (from ``forward(want_cache=True)``), valid below ``lens[r]``, lands in
    lane ``lanes[r]`` (lanes distinct); rows past ``len(lanes)`` are the
    batch's pad rows and are dropped, leaf by leaf.  Attention and MLA
    rows go through the layout (a windowed layer keeps the last ``window``
    positions); RG-LRU and SSM states scatter into their lanes, so their
    rows must be of exact length; a state held in part on this rank (an
    RG-LRU state on the split slab) takes the rank's columns.  An SSM conv
    tail of a prompt shorter than ``conv_width - 1`` is left-padded with
    zeros, what the causal conv saw before position 0 (the reference's
    ``model.py:953-963``)."""
    plan = layer_plan(cfg)
    layout = layout or SlabLayout()
    tables, n = cache.get("tables"), lanes.shape[0]
    for path, kind, stack in _groups(plan):
        c = _at(cache, path)
        rows = dict(zip(_cache_entries(kind, cfg), _at(produced, path)))
        if not stack:  # an unstacked layer written as a stack of one (views: in place)
            c, rows = {k: v[None] for k, v in c.items()}, {k: v[None] for k, v in rows.items()}
        rows = {k: v[:, :n] for k, v in rows.items()}
        if _block_mixer_mlp(kind, cfg)[0] in ("rec", "ssm"):
            for name, x in rows.items():
                short = c[name].shape[2] - x.shape[2] if name == "conv" else 0
                if short:  # a tail (L, N, s < W - 1, C): zeros before it
                    x = torch.cat([x.new_zeros(x.shape[:2] + (short,) + x.shape[3:]), x], 2)
                if c[name].shape[-1] < x.shape[-1]:
                    x = x[..., slice(*sharded.own_range(x.shape[-1]))]
                c[name][:, lanes] = x.to(c[name].dtype)
        else:
            layout.write_rows(c, rows, lanes, lens, tables, window=cfg.local_window)
    cache["len"][lanes] = lens.to(torch.int32)
    return cache


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                cache: dict, layout=None, commit=None):
    """One serving step: tokens (B,) -> (logits (B, V), cache).

    Every lane writes its token at ``cache["len"]`` and attends over
    ``len + 1`` positions; ``cache["len"]`` then advances by one.  The cache
    is updated in place, ``cache["len"]`` too (a captured CUDA graph reads
    and writes every cache tensor at one address), and returned.

    ``commit`` ((B,) bool, optional) names the lanes whose step may change
    what later steps read: outside it the RG-LRU state and conv tail keep
    their values and a rolling window slab neither rolls nor overwrites
    its newest row.  Other K/V writes land at the lane's ``len``, a slot
    no step reads before the lane's next write there."""
    plan = layer_plan(cfg)
    layout = layout or SlabLayout()
    pos = cache["len"]
    tables = cache.get("tables")
    x = _embed(params, cfg, tokens)[:, None, :]
    for i, kind in enumerate(plan.head):
        x = _block_decode(x, params[f"head_{i}"], kind, cfg, cache[f"head_{i}"], pos,
                          layout, tables, commit)
    for i in range(plan.n_body):
        for j, kind in enumerate(plan.period):
            sb = f"sb_{j}"
            x = _block_decode(x, _layer(params["body"][sb], i), kind, cfg,
                              _layer(cache["body"][sb], i), pos, layout, tables, commit)
    for i, kind in enumerate(plan.tail):
        x = _block_decode(x, params[f"tail_{i}"], kind, cfg, cache[f"tail_{i}"], pos,
                          layout, tables, commit)
    pos.add_(1)
    return _unembed(x, params, cfg)[:, 0], cache


def _attn_chunk(x, p, cfg: ArchConfig, c: dict, lanes, starts, lengths, layout, tables,
                chunk: int):
    """One prompt chunk per row: row ``r`` of x ``(R, C, d)`` writes K/V at
    positions ``starts[r] + i`` of lane ``lanes[r]`` and its queries attend
    over that lane's cached prefix: the full view, or on a pool's window
    table the ``win + C - 1`` positions ending at the chunk's last (its
    left edge below position 0 masked)."""
    csz = x.shape[1]
    positions = starts.long()[:, None] + torch.arange(csz, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions)
    windowed = layout.kind == "paged" and layout._windowed(cfg.local_window)
    window = cfg.local_window if windowed else None
    layout.write_chunk(c, {"k": k, "v": v}, lanes, starts, lengths, tables, window=window)
    if windowed:
        win = layout.view_window(window)
        view = layout.chunk_view_win(c, lanes, starts, csz, window, tables)
        attn = L.chunked_attention(  # q[:, 0] sits at view slot win - 1
            q, view["k"], view["v"], window=win, q_offset=win - 1,
            kv_valid_from=(win - 1 - starts.long()).clamp(min=0), chunk=chunk)
    else:
        view = layout.chunk_view(c, lanes, tables)
        attn = L.chunked_attention(q, view["k"], view["v"], q_offset=starts, chunk=chunk)
    return _out(attn, p, cfg)


def _block_chunk(x, p, kind: str, cfg: ArchConfig, c: dict, lanes, starts, lengths, layout,
                 tables, chunk: int):
    h = _apply_norm(cfg, p["pre"], x)
    mixer = _block_mixer_mlp(kind, cfg)[0]
    if mixer == "mla":
        mix = MLA.mla_chunk(h, p["attn"], cfg.n_heads, cfg.mla, c, lanes, starts, lengths,
                            cfg.rope_theta, layout, tables, chunk)
    elif mixer == "attn":
        mix = _attn_chunk(h, p["attn"], cfg, c, lanes, starts, lengths, layout, tables, chunk)
    else:
        raise NotImplementedError(
            "chunked prefill needs attention-family mixers (recurrent state cannot resume "
            "mid-prompt); the engine keeps such archs off it")
    return _mlp(x + mix, p, kind, cfg)[0]


def prefill_chunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor, cache: dict, lanes,
                  starts, lengths, layout=None, *, chunk: int = 512,
                  all_logits: bool = False):
    """One prompt chunk of every chunking lane against the live serving
    cache (the reference's ``prefill_chunk``): tokens ``(R, C)``, row ``r``
    valid below ``lengths[r]`` and lying at positions ``starts[r]..`` of
    lane ``lanes[r]`` (a lane ``>= B`` marks a pad row, which writes
    nothing).  Every layer writes the rows' K/V (or MLA latents) into the
    cache in place and attends through each lane's cached prefix; the
    lanes' ``cache["len"]`` become ``starts + lengths``.  Returns
    ``(logits (R, V) at each row's last valid position, cache)``: they
    matter on a lane's final chunk, where they seed its first token.
    Attention-family archs only.

    ``all_logits=True`` (the speculative verify pass) unembeds every slot:
    logits ``(R, C, V)``, slot ``j`` scoring position ``starts[r] + j``;
    pad slots are garbage for the caller to mask."""
    plan = layer_plan(cfg)
    layout = layout or SlabLayout()
    tables = cache.get("tables")
    x = _embed(params, cfg, tokens)
    for i, kind in enumerate(plan.head):
        x = _block_chunk(x, params[f"head_{i}"], kind, cfg, cache[f"head_{i}"], lanes, starts,
                         lengths, layout, tables, chunk)
    for i in range(plan.n_body):
        for j, kind in enumerate(plan.period):
            sb = f"sb_{j}"
            x = _block_chunk(x, _layer(params["body"][sb], i), kind, cfg,
                             _layer(cache["body"][sb], i), lanes, starts, lengths, layout,
                             tables, chunk)
    for i, kind in enumerate(plan.tail):
        x = _block_chunk(x, params[f"tail_{i}"], kind, cfg, cache[f"tail_{i}"], lanes, starts,
                         lengths, layout, tables, chunk)
    # each row's new length, into its lane (pad rows match no lane)
    hit = torch.arange(cache["len"].shape[0], device=lanes.device)[:, None] == lanes[None, :]
    new = (hit * (starts + lengths).to(cache["len"].dtype)[None, :]).sum(1)
    cache["len"].copy_(torch.where(hit.any(1), new.to(cache["len"].dtype), cache["len"]))
    if all_logits:
        return _unembed(x, params, cfg), cache
    last = (lengths.long() - 1).clamp(0, tokens.shape[1] - 1)
    x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    return _unembed(x_last, params, cfg)[:, 0], cache


def read_cache(cfg: ArchConfig, cache: dict, lanes: torch.Tensor, layout=None) -> dict:
    """Every attention and MLA layer's cached entries of ``lanes`` ((R,)),
    in f32 (int8 pages dequantized), in the structure of
    ``forward(want_cache=True)``'s caches: ``{"head_0": (ckv, krope), "body":
    {"sb_0": (k, v)}, ...}``, body entries stacked ``(L, R, S, ...)``, ``S``
    the layout's logical positions (the slab's rows, the pool's full
    table).  Append-only layers only: a rolling window slab or a window
    table is not in position order."""
    layout = layout or SlabLayout()
    tables = cache.get("tables")
    out: dict = {}
    for path, kind, stack in _groups(layer_plan(cfg)):
        if _block_mixer_mlp(kind, cfg)[0] not in ("attn", "mla"):
            continue
        c = _at(cache, path)
        views = [layout.chunk_view(_layer(c, i) if stack else c, lanes, tables)
                 for i in range(max(stack, 1))]
        _put(out, path, tuple(
            torch.stack([v[name].float() for v in views]) if stack else views[0][name].float()
            for name in _cache_entries(kind, cfg)))
    return out


def reset_lanes(cfg: ArchConfig, cache: dict, mask: torch.Tensor) -> dict:
    """Zero, in place, the RG-LRU and SSM ``state`` and ``conv`` rows of the
    lanes in ``mask`` ((B,) bool), the zeros a fresh prompt starts from
    (counterpart of ``repro/models/model.py:reset_lanes``).  The device
    scheduler refills a lane inside its decode loop: attention entries need
    no reset (stale K/V is dead under the lane's length once ``len`` is 0),
    but recurrent state is read whatever the length.  Archs without
    recurrent layers pass through."""
    for path, kind, stack in _groups(layer_plan(cfg)):
        if _block_mixer_mlp(kind, cfg)[0] not in ("rec", "ssm"):
            continue
        for x in _at(cache, path).values():  # (L, B, ...) stacked, else (B, ...)
            lead = 1 if stack else 0
            m = mask.reshape((1,) * lead + (-1,) + (1,) * (x.dim() - lead - 1))
            x.masked_fill_(m, 0)
    return cache


def copy_pages(cfg: ArchConfig, cache: dict, layout, src: torch.Tensor,
               dst: torch.Tensor) -> dict:
    """Copy the paged cache's pages ``src`` over ``dst``, in place, in
    every attention and MLA layer (``PagedLayout.copy_pages``); RG-LRU
    and SSM rows are per lane and have no pages."""
    for path, kind, stack in _groups(layer_plan(cfg)):
        if _block_mixer_mlp(kind, cfg)[0] in ("attn", "mla"):
            layout.copy_pages(_at(cache, path), src, dst, 1 if stack else 0)
    return cache


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, max_len: int):
    """Prompt (B, S) -> (last logits (B, V), a fresh slab cache holding it)."""
    logits, produced = forward(params, cfg, tokens, want_cache=True)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    lanes = torch.arange(b, device=tokens.device)
    write_prefill(cache, cfg, produced, lanes,
                  torch.full((b,), s, dtype=torch.int32, device=tokens.device))
    return logits[:, -1], cache

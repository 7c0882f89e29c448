"""Continuous-batching decode engine, sync scheduler (counterpart of
``repro/serving/engine.py``).

The engine serves the tree it is given as it is: hand it the N:M-compressed
artifact and every weight matmul of prefill and decode goes through the
``nm_spmm`` kernel.  It owns the KV cache (a per-lane slab, or the paged
pool of ``kv_pool.PagedKVPool`` when ``num_pages`` is given) and a FIFO
request queue.

One scheduling step (:meth:`step`):

1. **Admission.**  Queued requests move into free lanes while the pool (if
   paged) can back their prompts.  Admitted prompts are padded to a bucket
   length (powers of two up to ``max_len`` by default) and each bucket group
   is prefilled in one batched forward; a group is padded to a power of two
   rows with sentinel rows that write nothing.  Archs with recurrent
   (RG-LRU) layers group prompts by exact length instead, since pad tokens
   would run into the recurrent state and the conv tail.  Each row's first
   token is sampled from its last prompt position.
2. **Capacity.**  On the paged layout every decoding lane reserves the pages
   of its next K writes (``ensure_steps``), oldest lane first; when the
   pool runs dry the youngest lane is preempted: its pages are freed and the
   request is requeued at the front with its generated tokens as a resume
   prefix, which is prefilled with the prompt on re-admission.  With
   ``kv_quant`` the pool stores int8 pages (``models.cache``), about half
   the bytes of bf16 pages, so the same bytes hold twice the tokens.
3. **Decode.**  K decode steps run back to back on the device
   (``steps_per_dispatch``; the reference's ``lax.scan`` is a Python loop
   here) with per-lane stops applied on the device (``advance_stops``): a
   lane that hits EOS, its token budget or ``max_len`` freezes.  The host
   reads the ``(K, B)`` token block once, then replays the same stop rules.

Mesh serving (``mesh=``, one ``launch.mesh.Mesh`` rank's view; the
reference's ``DecodeEngine(mesh=, kv_shard=)``): every rank runs an engine
over the same whole tree and keeps only its shard of it
(``distributed.compressed_pspecs.shard_serving_params``) and its page
range of the pool (``kv_shard="seq"``); prefill and decode combine the
shards with collectives (``kernels.sharded``), so the logits are
replicated bit for bit and every rank's host scheduler takes the same
decisions.  Only the dense family on the paged pool with a data axis of 1
is ported; the slab under a model axis, ``data > 1`` and other families
raise (ROADMAP.md §1 item 1).  A 1×1 mesh runs exactly the single-device
engine.

Chunked prefill, prefix caching, the device-resident scheduler and
speculative decoding are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.compressed_pspecs import check_kv_shard, shard_serving_params
from repro_torch.kernels import dispatch, sharded
from repro_torch.models.cache import SlabLayout
from repro_torch.models.model import (
    _at,
    _block_mixer_mlp,
    _groups,
    check_mesh,
    decode_step,
    forward,
    init_cache,
    layer_plan,
    write_prefill,
)
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.sampling import (
    SamplingParams,
    advance_stops,
    request_seed,
    sample_tokens,
)
from repro_torch.sparse_infer.compress import CompressedTensor, tree_nbytes
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_items


@dataclasses.dataclass
class GenerationResult:
    uid: int
    prompt: list[int]
    tokens: list[int]  # generated tokens (eos not included)
    finish_reason: str  # "eos" | "length" | "cache_full"


@dataclasses.dataclass
class _Request:
    uid: int
    prompt: list[int]
    sampling: SamplingParams
    prefix: list[int] = dataclasses.field(default_factory=list)  # resume after preemption


class _Slot:
    """Host bookkeeping of one busy lane."""

    __slots__ = ("uid", "prompt", "sampling", "generated", "pos", "seq")

    def __init__(self, req: _Request, pos: int, seq: int):
        self.uid = req.uid
        self.prompt = req.prompt
        self.sampling = req.sampling
        self.generated: list[int] = list(req.prefix)
        self.pos = pos  # host mirror of cache["len"][lane]
        self.seq = seq  # admission order; preemption evicts the youngest


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class DecodeEngine:
    """Batched greedy/sampled decode over a slab or paged cache.

    ``params`` (dense tensors and/or ``CompressedTensor`` leaves) must lie on
    ``device``; on ``cuda`` the kernels are built and loaded here, before
    any timed work.  With ``mesh`` the engine runs on the mesh's device and
    takes the whole tree from anywhere (e.g. memory-mapped on the CPU),
    keeping only this rank's shard of it.
    """

    def __init__(
        self, cfg, params: dict, *, max_batch: int = 8, max_len: int = 128,
        seed: int = 0, num_pages: Optional[int] = None, page_size: int = 16,
        steps_per_dispatch: int = 1, kv_quant: bool = False,
        prefill_buckets: Optional[Sequence[int]] = None, device="cuda",
        mesh=None, kv_shard: str = "seq",
    ):
        self.device = resolve_device(device)
        check_kv_shard(mesh, kv_shard)  # pools shard pages: "feature" only where trivial
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"mesh on {mesh.device}, engine asked for {self.device}")
            if mesh.data > 1:
                raise NotImplementedError("a data axis > 1 is not ported yet (ROADMAP.md §1 "
                                          "item 1)")
            check_mesh(cfg, mesh)
            if mesh.model > 1 and num_pages is None:
                raise NotImplementedError("the slab under a model axis > 1 is not ported yet "
                                          "(ROADMAP.md §1 item 1); pass num_pages")
            self.device = mesh.device
            params = shard_serving_params(params, mesh, cfg=cfg)
        for name, leaf in tree_items(params):
            t = leaf.values if isinstance(leaf, CompressedTensor) else leaf
            if t.device.type != self.device.type:
                raise ValueError(f"param {name} is on {t.device}, engine on {self.device}")
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if kv_quant and num_pages is None:
            # the slab stays fp: serving it would fake the int8 pool's byte saving
            raise ValueError("kv_quant=True needs the paged pool (num_pages)")
        if self.device.type == "cuda":
            dispatch.load_kernels()
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.max_batch = max_batch
        self.max_len = max_len
        self.seed = seed
        self.steps_per_dispatch = steps_per_dispatch
        if num_pages is not None:
            self.pool: Optional[PagedKVPool] = PagedKVPool(
                cfg, max_batch=max_batch, max_len=max_len, num_pages=num_pages,
                page_size=page_size, lookahead=steps_per_dispatch, quant=kv_quant,
                device=self.device, mesh=mesh)
            self.layout = self.pool.layout
            self.cache = self.pool.cache
        else:
            self.pool = None
            self.layout = SlabLayout(max_len)
            self.cache = init_cache(cfg, max_batch, max_len, device=self.device)
        if prefill_buckets:
            buckets = sorted(int(b) for b in prefill_buckets if 0 < int(b) <= max_len)
        else:
            buckets, b = [], 8
            while b < max_len:
                buckets.append(b)
                b *= 2
        if not buckets or buckets[-1] < max_len:
            buckets.append(max_len)
        self.prefill_buckets = tuple(buckets)
        # each layer's (mixer, stacked layers), for the cache byte counts
        self._mixers = [(_block_mixer_mlp(kind, cfg)[0], path, max(stack, 1))
                        for path, kind, stack in _groups(layer_plan(cfg))]
        # recurrent state cannot absorb pad tokens: group prompts by exact length
        self._exact_prefill = any(m == "rec" for m, _, _ in self._mixers)

        self.slots: list[Optional[_Slot]] = [None] * max_batch
        self.queue: deque[_Request] = deque()
        self.tokens = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self._next_uid = 0
        self._admit_seq = 0
        self.decode_steps = 0
        self.dispatches = 0
        self.admitted = 0
        self.preemptions = 0
        self.max_concurrency = 0
        self.prefill_batches = 0
        self.tokens_generated = 0
        self.decode_tokens = 0
        self.decode_collectives = 0  # collectives over the mesh during decode
        self.decode_collective_s = 0.0  # host seconds inside them
        self.kv_bytes_sum = 0  # live KV bytes a decode step reads, summed per dispatch
        self.decode_wall_s = 0.0  # decode dispatch wall time, device included
        self.sched_host_s = 0.0  # host scheduling time around dispatches
        self._itl_ms: list[float] = []
        self._last_emit: dict[int, float] = {}

    # -- request intake ------------------------------------------------------

    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None) -> int:
        """Enqueue a request; returns its uid."""
        prompt = [int(t) for t in prompt]
        sampling = sampling or SamplingParams()
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt length {len(prompt)} >= cache capacity {self.max_len}")
        if self.pool is not None:
            cap = min(len(prompt) + sampling.max_new_tokens, self.max_len)
            need = self.pool.pages_for_request(cap)
            if need > self.pool.layout.num_pages:
                raise ValueError(
                    f"request needs up to {need} pages but the pool has only "
                    f"{self.pool.layout.num_pages}; raise --num-pages or lower "
                    "max_new_tokens")
        uid = self._next_uid
        self._next_uid += 1
        self.queue.append(_Request(uid, prompt, sampling))
        return uid

    # -- scheduling ----------------------------------------------------------

    def _finish(self, i: int, reason: str, out: list) -> None:
        s = self.slots[i]
        out.append(GenerationResult(s.uid, s.prompt, s.generated, reason))
        self.tokens_generated += len(s.generated)
        self.slots[i] = None
        self._last_emit.pop(s.uid, None)
        if self.pool is not None:
            self.pool.release(i)

    def _absorb(self, i: int, token: int, out: list, *, from_decode: bool = False) -> None:
        """Record a sampled token for lane i; finish on a stop.  Mirrors
        ``sampling.advance_stops``."""
        s = self.slots[i]
        sp = s.sampling
        if sp.eos_id >= 0 and token == sp.eos_id:
            self._finish(i, "eos", out)
            return
        s.generated.append(token)
        now = time.perf_counter()
        last = self._last_emit.get(s.uid)
        if last is not None:
            self._itl_ms.append((now - last) * 1e3)
        self._last_emit[s.uid] = now
        if from_decode:
            self.decode_tokens += 1
        if len(s.generated) >= sp.max_new_tokens:
            self._finish(i, "length", out)
        elif len(s.prompt) + len(s.generated) >= self.max_len:
            self._finish(i, "cache_full", out)

    def _preempt(self, i: int) -> None:
        """Evict lane i: free its pages, requeue it with a resume prefix."""
        s = self.slots[i]
        self.slots[i] = None
        self.pool.release(i)
        self.preemptions += 1
        self.queue.appendleft(_Request(s.uid, s.prompt, s.sampling, prefix=list(s.generated)))

    def _bucket(self, n: int) -> int:
        if self._exact_prefill:
            return n
        return next((b for b in self.prefill_buckets if b >= n), self.prefill_buckets[-1])

    def _admit(self, out: list) -> None:
        picked: list[tuple[_Request, int, int]] = []
        while self.queue:
            i = next((j for j, s in enumerate(self.slots) if s is None), None)
            if i is None:
                break
            req = self.queue[0]
            length = len(req.prompt) + len(req.prefix)
            if self.pool is not None and not self.pool.alloc_prefill(i, length):
                break  # retry next step, after frees/preemptions
            self.queue.popleft()
            self.slots[i] = _Slot(req, pos=length, seq=self._admit_seq)
            self._admit_seq += 1
            picked.append((req, i, length))
        groups: dict[int, list] = {}
        for item in picked:
            groups.setdefault(self._bucket(item[2]), []).append(item)
        for lb in sorted(groups):
            self._prefill_group(lb, groups[lb], out)

    def _prefill_group(self, lb: int, items: list, out: list) -> None:
        n_real, nb = len(items), _next_pow2(len(items))
        tokens = np.zeros((nb, lb), np.int64)  # pad rows: zeros, never written
        lens = np.zeros((n_real,), np.int32)
        lanes = np.zeros((n_real,), np.int64)
        for r, (req, i, length) in enumerate(items):
            tokens[r, :length] = req.prompt + req.prefix
            lens[r], lanes[r] = length, i
        dev = self.device
        lens_t = torch.from_numpy(lens).to(dev)
        lanes_t = torch.from_numpy(lanes).to(dev)
        if self.pool is not None:
            self.pool.device_tables()
        logits_all, produced = forward(self.params, self.cfg,
                                       torch.from_numpy(tokens).to(dev), want_cache=True)
        write_prefill(self.cache, self.cfg, produced, lanes_t, lens_t, self.layout)
        logits = logits_all[torch.arange(n_real, device=dev), lens_t.long() - 1]
        temps = torch.tensor([req.sampling.temperature for req, _, _ in items],
                             dtype=torch.float32, device=dev)
        topks = torch.tensor([req.sampling.top_k for req, _, _ in items],
                             dtype=torch.int32, device=dev)
        need_sample = any(req.sampling.temperature > 0 for req, _, _ in items)
        seeds = ([request_seed(self.seed, req.uid, len(req.prefix)) for req, _, _ in items]
                 if need_sample else None)
        first = sample_tokens(logits, temps, topks, seeds, need_sample=need_sample,
                              need_topk=any(req.sampling.top_k > 0 for req, _, _ in items))
        self.tokens[lanes_t] = first
        self.prefill_batches += 1
        host_first = first.cpu().tolist()
        for r, (_, i, _) in enumerate(items):
            self.admitted += 1
            self._absorb(i, host_first[r], out)

    def _ensure_capacity(self) -> None:
        """Back every decoding lane's next K writes, oldest first; preempt
        the youngest lane on pressure."""
        if self.pool is None:
            return
        order = sorted((i for i, s in enumerate(self.slots) if s is not None),
                       key=lambda i: self.slots[i].seq)
        for i in order:
            s = self.slots[i]
            if s is None:  # evicted as an earlier lane's victim
                continue
            # a lane whose budget ends inside the dispatch freezes there:
            # reserve only the writes it can reach
            k = max(1, min(self.steps_per_dispatch,
                           max(1, s.sampling.max_new_tokens - len(s.generated)),
                           self.max_len - s.pos))
            while self.slots[i] is not None and not self.pool.ensure_steps(i, s.pos, k):
                victim = max((j for j, t in enumerate(self.slots) if t is not None),
                             key=lambda j: self.slots[j].seq)
                self._preempt(victim)

    def _decode(self, k: int) -> torch.Tensor:
        """K decode steps for every lane; returns the ``(K, B)`` token block.

        Occupied lanes decode until they freeze, then keep their length;
        free lanes stay pinned at length 0 (their writes land on the slab's
        row 0 or the pool's sink page and are never read)."""
        dev = self.device
        slots = self.slots
        occupied = torch.tensor([s is not None for s in slots], device=dev)
        active = occupied
        temps = torch.tensor([s.sampling.temperature if s else 0.0 for s in slots],
                             dtype=torch.float32, device=dev)
        topks = torch.tensor([s.sampling.top_k if s else 0 for s in slots],
                             dtype=torch.int32, device=dev)
        eos = torch.tensor([s.sampling.eos_id if s else -1 for s in slots],
                           dtype=torch.int32, device=dev)
        budget = torch.tensor(
            [s.sampling.max_new_tokens - len(s.generated) if s else 0 for s in slots],
            dtype=torch.int32, device=dev)
        need_sample = any(s is not None and s.sampling.temperature > 0 for s in slots)
        need_topk = any(s is not None and s.sampling.top_k > 0 for s in slots)
        tok, cache, block = self.tokens, self.cache, []
        for t in range(k):
            len_prev = cache["len"]
            logits, cache = decode_step(self.params, self.cfg, tok, cache, self.layout)
            cache["len"] = torch.where(active, cache["len"],
                                       torch.where(occupied, len_prev, 0))
            # a lane still active at step t has sampled len(generated) + t
            # tokens; a frozen lane's draw is discarded by advance_stops
            seeds = ([request_seed(self.seed, s.uid, len(s.generated) + t) if s else 0
                      for s in slots] if need_sample else None)
            nxt = sample_tokens(logits, temps, topks, seeds,
                                need_sample=need_sample, need_topk=need_topk)
            tok, active, budget = advance_stops(nxt, active, budget, eos,
                                                cache["len"], self.max_len)
            block.append(tok)
        self.tokens = tok
        return torch.stack(block)

    def _mesh_ctx(self):
        """The mesh sharded leaves and pools combine over, around prefill
        and decode (a no-op without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharded.mesh_context(self.mesh)

    def step(self) -> list[GenerationResult]:
        """Admit, reserve, run one K-step decode dispatch; return the
        requests that finished."""
        with self._mesh_ctx():
            return self._step()

    def _step(self) -> list[GenerationResult]:
        out: list[GenerationResult] = []
        self._admit(out)
        t_sched0 = time.perf_counter()
        self._ensure_capacity()
        live = [i for i, s in enumerate(self.slots) if s is not None]
        self.max_concurrency = max(self.max_concurrency, len(live))
        if not live:
            return out
        if self.pool is not None:
            self.pool.device_tables()
        self.kv_bytes_sum += self.live_kv_bytes()
        k = self.steps_per_dispatch
        t0 = time.perf_counter()
        c0, s0 = sharded.collectives, sharded.collective_s
        host_block = self._decode(k).cpu().numpy()  # one host sync per K tokens
        t1 = time.perf_counter()
        self.decode_collectives += sharded.collectives - c0
        self.decode_collective_s += sharded.collective_s - s0
        self.decode_wall_s += t1 - t0
        self.decode_steps += k
        self.dispatches += 1
        for t in range(k):
            for i in live:
                self.slots[i].pos += 1
            for i in list(live):
                self._absorb(i, int(host_block[t, i]), out, from_decode=True)
                if self.slots[i] is None:
                    live.remove(i)
        self.sched_host_s += (t0 - t_sched0) + (time.perf_counter() - t1)
        return out

    def run(self) -> dict[int, GenerationResult]:
        """Drain the queue and every busy lane; results keyed by uid."""
        results: dict[int, GenerationResult] = {}
        while self.queue or any(s is not None for s in self.slots):
            for r in self.step():
                results[r.uid] = r
        return results

    # -- reporting -----------------------------------------------------------

    def kv_cache_bytes(self) -> int:
        """Device bytes of the attention and MLA cache storage (slab, or
        pool with its sink page), summed over their layers' leaves."""
        return sum(t.numel() * t.element_size()
                   for mixer, path, _ in self._mixers if mixer in ("attn", "mla")
                   for _, t in tree_items(_at(self.cache, path)))

    def _kv_row_bytes(self) -> tuple[int, int]:
        """(append-only, windowed) cache bytes of one token of one lane,
        summed over layers: windowed attention layers keep at most the
        window's tokens, the others (and MLA) every token.  Counted at the
        param dtype's width even for int8 pages, as the reference counts
        them, so the number stays comparable across pools."""
        cfg = self.cfg
        item = getattr(torch, cfg.param_dtype).itemsize
        windowed = cfg.local_window is not None and cfg.local_window <= self.max_len
        full_b = win_b = 0
        for mixer, _, n in self._mixers:
            if mixer == "attn":
                rb = n * 2 * cfg.n_kv * cfg.hd * item
                if windowed:
                    win_b += rb
                else:
                    full_b += rb
            elif mixer == "mla":
                full_b += n * (cfg.mla.kv_lora + cfg.mla.rope_head_dim) * item
        return full_b, win_b

    def live_kv_bytes(self) -> int:
        """KV bytes the paged kernel reads in one decode step: each busy
        lane's live tokens once, the window's at most in windowed layers."""
        full_b, win_b = self._kv_row_bytes()
        win = (min(self.max_len, self.cfg.local_window)
               if self.cfg.local_window is not None else self.max_len)
        return sum(full_b * min(s.pos + 1, self.max_len) + win_b * min(s.pos + 1, win)
                   for s in self.slots if s is not None)

    def kernel_route(self) -> str:
        """Which paged-attention implementation decode runs: ``"slab"`` when
        none, else ``"cuda"`` (the kernel) or ``"plain"`` (CPU tensors),
        prefixed ``"shard_map/"`` (the reference's name of the route) where
        a pages-sharded pool runs the stats form and the combine."""
        if self.pool is None:
            return "slab"
        inner = "cuda" if self.device.type == "cuda" else "plain"
        return f"shard_map/{inner}" if self.layout.shards > 1 else inner

    def stats(self) -> dict:
        """Throughput counts decode-produced tokens over decode wall time;
        each request's first token comes from prefill and is excluded."""
        steps = self.decode_steps
        total_wall = self.decode_wall_s + self.sched_host_s
        st = {
            "layout": self.layout.kind,
            "decode_steps": steps,
            "dispatches": self.dispatches,
            "steps_per_dispatch": self.steps_per_dispatch,
            "host_syncs": self.dispatches,
            "itl_ms_p50": float(np.percentile(self._itl_ms, 50)) if self._itl_ms else 0.0,
            "itl_ms_p99": float(np.percentile(self._itl_ms, 99)) if self._itl_ms else 0.0,
            "admitted": self.admitted,
            "preemptions": self.preemptions,
            "max_concurrency": self.max_concurrency,
            "prefill_batches": self.prefill_batches,
            "tokens_generated": self.tokens_generated,
            "decode_tokens": self.decode_tokens,
            "decode_wall_s": self.decode_wall_s,
            "sched_host_s": self.sched_host_s,
            "kv_cache_bytes": self.kv_cache_bytes(),
            "kv_bytes_per_step": (self.kv_bytes_sum / self.dispatches
                                  if self.dispatches else 0.0),
            "weight_bytes_per_step": tree_nbytes(self.params),
            "ms_per_decode_step": self.decode_wall_s / steps * 1e3 if steps else 0.0,
            "ms_per_decode_step_host": self.sched_host_s / steps * 1e3 if steps else 0.0,
            "host_overhead_frac": self.sched_host_s / total_wall if total_wall > 0 else 0.0,
            "tokens_per_s": (self.decode_tokens / self.decode_wall_s
                             if self.decode_wall_s > 0 else 0.0),
            "mesh": self.mesh.describe() if self.mesh is not None else None,
            "collectives_per_decode_step": self.decode_collectives / steps if steps else 0.0,
            "collective_ms_per_decode_step": (self.decode_collective_s / steps * 1e3
                                              if steps else 0.0),
        }
        if self.pool is not None:
            st.update(
                num_pages=self.pool.layout.num_pages,
                page_size=self.pool.layout.page_size,
                used_pages=self.pool.used_pages,
                evicted_pages=self.pool.evicted_pages,
                table_full_uploads=self.pool.table_full_uploads,
                table_row_syncs=self.pool.table_row_syncs,
                table_syncs=self.pool.table_syncs,
                kv_quant=self.pool.layout.quant,
            )
        return st

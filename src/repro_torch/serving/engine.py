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
   (RG-LRU or SSM) layers group prompts by exact length instead, since pad
   tokens would run into the recurrent state and the conv tail.  Each row's first
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

Mesh serving (``mesh=``, one ``launch.mesh.Mesh`` rank's view of a
``(D, S)`` mesh; the reference's ``DecodeEngine(mesh=, kv_shard=)``):
every rank runs the same host scheduler over all ``max_batch`` lanes
(admission, buckets, pages, preemption, stop rules), so its host state is
global and identical on every rank.  The device work is split two ways:

- *the model axis* (``S``): each rank keeps only its shard of the whole
  tree (``distributed.compressed_pspecs.shard_serving_params``), its page
  range of the pool (``kv_shard="seq"``) or its rows of every lane of the
  slab (``SlabLayout.shards``); prefill and decode combine the shards with
  collectives over the model group (``kernels.sharded``), so the logits
  are replicated bit for bit within a data row;
- *the data axis* (``D``): each data row runs the device work of its own
  ``max_batch / D`` consecutive lanes (``compressed_pspecs.lane_range``,
  the reference's ``lane_sharding``): its slab, states, lengths and next
  tokens hold only those lanes, and its pool (its page range for every
  lane, the tables replicated) takes only their writes.  A prefill batch
  is prefilled by each row for its own lanes (a row with none skips the
  forward on all of its ranks), and the first tokens and each decode
  dispatch's ``(K, B/D)`` token block are gathered over the data group
  (``sharded.gather_data``: one collective a prefill batch and a
  dispatch, issued by every rank), so every host absorbs the same block.
  Where ``D`` does not divide ``max_batch`` every row holds every lane,
  as the reference's sanitized placement does, and nothing is gathered.

Every family serves so, with the sync scheduler, on the slab and on fp
and int8 pools.  Chunked prefill, the prefix cache, speculation and the
device scheduler over a mesh larger than 1×1 raise (the rest of tensor
parallelism, ROADMAP.md).  A 1×1 mesh runs exactly the single-device
engine.

Device-resident scheduling (``max_steps_per_dispatch=K``, the reference's
run-until-stop loop): a cycle is one host sync.  The host admits, reserves
every lane's pages up to the write horizon ``K × W`` (``W`` = 2 dispatches
a cycle with ``async_stream``, else 1), stages up to ``staged_lanes``
queued prompts (``PagedKVPool.stage_alloc``) and writes the loop's state;
then ``W`` dispatches of ``serving.device_loop`` run back to back, each
decoding until some lane freezes with no refill to cover it, the K-step
bound, or nothing live and nothing staged.  Inside a dispatch a frozen
lane takes the next staged prompt, fed token by token through decode.
The host fetches each dispatch's token block in launch order and replays
it through the same stop rules (``_replay``), installing the refills
where the loop made them.  On the card a dispatch is a captured CUDA
graph, replayed; on the CPU the same iterations run eagerly.  Draws are
keyed per (request, token index), so greedy and sampled streams equal the
sync scheduler's however the dispatches were cut.

Chunked prefill (``prefill_chunk=C``, the reference's): a prompt longer
than ``C`` takes its lane and its pages at admission but is absorbed ``C``
tokens a step, one chunk of every chunking lane in one batched forward
(``models.model.prefill_chunk``, rows padded to a power of two with
sentinel lanes), interleaved with the decode dispatches; its last chunk's
logits seed its first token.  Archs with recurrent layers keep the
monolithic prefill (their state cannot resume mid-prompt), and a windowed
arch chunks only on the pool, whose window table each chunk maps just
before it runs.  The device scheduler drains every chunking prompt before
its cycle.

The prefix cache (``prefix_cache=True``, the reference's): admission asks
the radix index (``serving.prefix_cache``) for the prompt's longest cached
prefix, maps those pages shared into the lane's table and absorbs only
the uncached tail, through the chunk path; a prefilled prompt's pages go
into the index.  A shared page about to be written is forked first
(copy-on-write, ``kv_pool``), and the copies land in place before the next
forward or dispatch.  It needs the pool's append-only table on an arch
without a window or recurrent layers; elsewhere it is refused with a
warning.  Refills inside the device loop bypass the index, as in the
reference.

Self-speculative decoding (``spec_gamma=G``, ``verify_params=``, the
reference's): ``params`` becomes the drafter (the compressed N:M artifact)
and ``verify_params`` (the masked-dense tree, or a denser N:M artifact)
the verifier, which from then on is ``self.params``: prefill and chunks
run it, so every committed K/V entry is the verifier's.  A step is one
round: up to ``G`` decode steps of the drafter propose tokens per lane
(lane ``i`` drafts ``gi = min(G, room, budget - 1)``; the scan runs
``max(gi)`` steps, and ``len`` returns to the round's start), then one
chunked verify pass (``prefill_chunk(all_logits=True)``) of every lane's
``[last token, drafts]`` at its committed length rescores all ``gi + 1``
positions and rewrites their K/V; ``sampling.spec_accept`` keeps the
longest valid draft prefix (greedy: argmax match; sampled: the rejection
rule) plus one verifier token, and ``len`` rewinds on the device to the
accepted length.  The host reads the round's ``(tokens, n_acc)`` once,
absorbs them through the stop rules and rolls each live lane's pages
back to its length (``PagedKVPool.rollback``).  Greedy streams equal
plain decoding under the verifier, whatever the drafter proposes; sampled
streams follow the verifier's distribution.  The round runs eagerly on
the sync scheduler; windowed and recurrent archs, the device scheduler
and a model axis or a data axis > 1 are refused.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.compressed_pspecs import (
    check_kv_shard,
    lane_range,
    shard_serving_params,
)
from repro_torch.kernels import dispatch, sharded
from repro_torch.models.cache import SlabLayout
from repro_torch.models.model import (
    _at,
    _block_mixer_mlp,
    _groups,
    decode_step,
    forward,
    init_cache,
    layer_plan,
    prefill_chunk,
    write_prefill,
)
from repro_torch.serving.device_loop import LANE_ROWS, RING_ROWS, DeviceLoop
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixIndex
from repro_torch.serving.sampling import (
    SamplingParams,
    advance_stops,
    draw_keys,
    filtered_probs,
    sample_tokens,
    spec_accept,
)
from repro_torch.sparse_infer.compress import CompressedTensor, tree_nbytes
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_items

# pick_spec_gamma's acceptance (a typical magnitude-pruned drafter's
# agreement with its dense parent, the reference's default) and longest draft
SPEC_ALPHA = 0.75
SPEC_G_MAX = 16


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

    __slots__ = ("uid", "prompt", "sampling", "generated", "pos", "seq", "pending", "feed")

    def __init__(self, req: _Request, pos: int, seq: int,
                 pending: Optional[list[int]] = None, feed: bool = False):
        self.uid = req.uid
        self.prompt = req.prompt
        self.sampling = req.sampling
        self.generated: list[int] = list(req.prefix)
        self.pos = pos  # host mirror of cache["len"][lane]
        self.seq = seq  # admission order; preemption evicts the youngest
        # prompt (+ resume prefix) tokens not yet in the cache; with feed
        # they drain token by token inside the device loop (a refill),
        # without, the host absorbs them chunk by chunk (chunked prefill, a
        # prefix hit's tail); such a lane holds its length and samples
        # nothing until they are in
        self.pending: list[int] = pending or []
        self.feed = feed


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

    ``max_steps_per_dispatch`` selects the device scheduler (module
    docstring), with ``staged_lanes`` and ``async_stream``; ``device_loop``
    picks its loop: ``"graph"`` (the default on the card, a captured CUDA
    graph) or ``"eager"`` (the CPU's; on the card only when asked for, to
    hold the graph against it).  ``prefill_chunk`` and ``prefix_cache``
    turn on chunked prefill and the prefix cache (module docstring);
    ``max_prefill_batch`` caps the requests one step admits.
    ``spec_gamma`` (an int >= 1, or ``"auto"``: :meth:`pick_spec_gamma`)
    with ``verify_params`` turns on self-speculative decoding (module
    docstring): ``params`` drafts, ``verify_params`` verifies and is
    served as ``self.params``.
    """

    def __init__(
        self, cfg, params: dict, *, max_batch: int = 8, max_len: int = 128,
        seed: int = 0, num_pages: Optional[int] = None, page_size: int = 16,
        steps_per_dispatch: int = 1, max_steps_per_dispatch: Optional[int] = None,
        staged_lanes: int = 0, async_stream: bool = False, kv_quant: bool = False,
        prefill_buckets: Optional[Sequence[int]] = None, device="cuda",
        mesh=None, kv_shard: str = "seq", device_loop: Optional[str] = None,
        prefill_chunk: Optional[int] = None, prefix_cache: bool = False,
        max_prefill_batch: Optional[int] = None, spec_gamma=None, verify_params: Optional[dict] = None,
    ):
        self.device = resolve_device(device)
        check_kv_shard(mesh, kv_shard)  # pools shard pages: "feature" only where trivial
        # a mesh beyond 1×1 takes the sync scheduler's plain prefill alone
        meshed = mesh is not None and (mesh.model > 1 or mesh.data > 1)
        self._device_sched = max_steps_per_dispatch is not None
        if self._device_sched and max_steps_per_dispatch < 1:
            raise ValueError(
                f"max_steps_per_dispatch must be >= 1, got {max_steps_per_dispatch}")
        if (staged_lanes or async_stream) and not self._device_sched:
            raise ValueError("staged_lanes/async_stream need the device scheduler: "
                             "pass max_steps_per_dispatch=")
        if staged_lanes < 0:
            raise ValueError(f"staged_lanes must be >= 0, got {staged_lanes}")
        if self._device_sched and meshed:
            raise NotImplementedError(
                "the device scheduler over a model axis or a data axis > 1 is not ported yet "
                "(the rest of tensor parallelism, ROADMAP.md): its collectives run on the host "
                "over gloo; serve the mesh with the sync scheduler")
        if (prefill_chunk is not None or prefix_cache) and meshed:
            raise NotImplementedError(
                "chunked prefill and the prefix cache over a model axis or a data axis > 1 "
                "are not ported yet (the rest of tensor parallelism, ROADMAP.md); serve the "
                "mesh without them")
        if device_loop is not None and not self._device_sched:
            raise ValueError("device_loop selects the device scheduler's loop: pass "
                             "max_steps_per_dispatch=")
        self.k_loop = max_steps_per_dispatch
        self.staged_lanes = staged_lanes
        self.async_stream = async_stream
        self._w = 2 if async_stream else 1
        # the write horizon: the most positions a lane can append between
        # two host syncs (K steps, or k_loop steps a dispatch times W
        # dispatches a cycle); page reservations and staging are sized by it
        self._horizon = self.k_loop * self._w if self._device_sched else steps_per_dispatch
        # each layer's (mixer, stacked layers), for the cache byte counts
        self._mixers = [(_block_mixer_mlp(kind, cfg)[0], path, max(stack, 1))
                        for path, kind, stack in _groups(layer_plan(cfg))]
        # recurrent state cannot absorb pad tokens: group prompts by exact length
        self._exact_prefill = any(m in ("rec", "ssm") for m, _, _ in self._mixers)
        windowed_arch = cfg.local_window is not None
        # speculative decoding: params drafts, verify_params verifies
        self._spec = spec_gamma is not None
        self._draft_params: Optional[dict] = None
        self.spec_gamma = 0
        if self._spec:
            if verify_params is None:
                raise ValueError("spec_gamma needs verify_params=: the masked-dense (or denser "
                                 "N:M) tree the drafts are verified against")
            if windowed_arch:
                raise ValueError("spec_gamma is not supported on sliding-window archs: a "
                                 "rejected draft cannot be rolled back out of the window table "
                                 "(pages the window slid past are already evicted)")
            if self._exact_prefill:
                raise ValueError("spec_gamma is not supported on SSM/RG-LRU archs: recurrent "
                                 "state advanced by a rejected draft cannot be rolled back")
            if self._device_sched:
                raise ValueError("spec_gamma needs the sync scheduler: drop "
                                 "max_steps_per_dispatch/staged_lanes/async_stream")
            if meshed:
                raise NotImplementedError(
                    "speculative decoding over a model axis or a data axis > 1 is not ported "
                    "yet (the rest of tensor parallelism, ROADMAP.md); serve the mesh without "
                    "spec_gamma")
            self._spec_draft_bytes = tree_nbytes(params)
            self._spec_verify_bytes = tree_nbytes(verify_params)
            if spec_gamma == "auto":
                spec_gamma = self.pick_spec_gamma(self._spec_draft_bytes,
                                                  self._spec_verify_bytes)
            spec_gamma = int(spec_gamma)
            if spec_gamma < 1:
                raise ValueError(f"spec_gamma must be >= 1 or 'auto', got {spec_gamma}")
            if spec_gamma >= max_len:
                raise ValueError(f"spec_gamma {spec_gamma} >= max_len {max_len}")
            self.spec_gamma = spec_gamma
            # a round writes gamma + 1 positions past the committed length
            # (the drafts and the verify pass's bonus slot)
            self._horizon = max(self._horizon, spec_gamma + 1)
            self._draft_params, params = params, verify_params
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"mesh on {mesh.device}, engine asked for {self.device}")
            self.device = mesh.device
            params = shard_serving_params(params, mesh, cfg=cfg)
            if self._spec:
                self._draft_params = shard_serving_params(self._draft_params, mesh, cfg=cfg)
        for tree in (params, self._draft_params or {}):
            for name, leaf in tree_items(tree):
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
        # this rank's lanes [lo, hi) of the device work (all of them but on
        # a data axis that divides them); split: the rows meet in gathers
        self._lo, self._hi = lane_range(mesh, max_batch)
        self._rows_split = self._hi - self._lo < max_batch
        # chunking needs every mixer to resume mid-prompt from the cache
        # (attention and MLA); a windowed arch also needs the pool, whose
        # window table the chunk view reads
        chunk_ok = (prefill_chunk is not None and not self._exact_prefill
                    and (not windowed_arch or num_pages is not None))
        if num_pages is not None:
            lookahead = max(steps_per_dispatch, self._horizon)
            if chunk_ok and windowed_arch:
                # a chunk walks prefill_chunk slots of the window table: a
                # lookahead of as many keeps them off the slots its view reads
                lookahead = max(lookahead, prefill_chunk)
            self.pool: Optional[PagedKVPool] = PagedKVPool(
                cfg, max_batch=max_batch, max_len=max_len, num_pages=num_pages,
                page_size=page_size, lookahead=lookahead,
                quant=kv_quant, device=self.device, mesh=mesh)
            self.layout = self.pool.layout
            self.cache = self.pool.cache
        else:
            self.pool = None
            # over a model axis each rank holds its rows of every lane
            self.layout = SlabLayout(max_len, shards=mesh.model if mesh is not None else 1,
                                     shard=mesh.model_index if mesh is not None else 0)
            self.cache = init_cache(cfg, self._hi - self._lo, max_len, layout=self.layout,
                                    device=self.device)
        # the cache the device work reads: this rank's rows of the page
        # tables (views: the pool's in-place syncs reach them)
        self._lane_cache = self.cache
        if self._rows_split and "tables" in self.cache:
            self._lane_cache = dict(self.cache, tables={
                k: t[self._lo:self._hi] for k, t in self.cache["tables"].items()})
        self.prefill_chunk = prefill_chunk if chunk_ok else None
        # windowed chunks map their window pages chunk by chunk
        self._win_chunk = self.prefill_chunk is not None and windowed_arch
        # the prefix cache rides the chunk path (a hit is a lane that has
        # absorbed its first chunks), with its arch gate, and needs an
        # append-only table that nothing evicts
        self._prefix: Optional[PrefixIndex] = None
        if prefix_cache:
            lay = self.pool.layout if self.pool is not None else None
            if (lay is not None and lay.has_full and not lay.win and not self._exact_prefill
                    and not windowed_arch):
                self._prefix = PrefixIndex(self.pool, lay.page_size)
            else:
                warnings.warn("prefix_cache=True ignored: needs a paged append-only full "
                              "table on an attention-family, non-windowed arch")
        # a prefix hit's tail goes through the chunk path even without chunking
        self._tail_chunk = self.prefill_chunk or min(64, max_len)
        self.max_prefill_batch = max_prefill_batch or max_batch
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

        self.slots: list[Optional[_Slot]] = [None] * max_batch
        self.queue: deque[_Request] = deque()
        self.tokens = torch.zeros((self._hi - self._lo,), dtype=torch.int32, device=self.device)
        self._next_uid = 0
        self._admit_seq = 0
        self.decode_steps = 0
        self.dispatches = 0
        self.admitted = 0
        self.preemptions = 0
        self.max_concurrency = 0
        self.prefill_batches = 0
        self.prefill_forwards = 0  # prefill batches this rank ran a forward for
        self.data_gathers = 0  # token gathers over the data group (split lanes)
        self.prefill_chunks = 0  # chunked-prefill forwards
        self.prefix_hits = 0  # admissions that mapped cached prefix pages
        self.prefix_hit_tokens = 0  # prompt tokens they did not prefill
        self.tokens_generated = 0
        self.decode_tokens = 0
        self.cycles = 0  # device-scheduler cycles (one host sync each)
        self.refills = 0  # lanes refilled inside the device loop
        self.block_fetches = 0  # device-to-host token-block reads
        # staged queue entries of this cycle: {"req", "rec" (the pool's
        # stage_alloc record or None), "tokens", "len"}
        self._staged: list[dict] = []
        self._loop: Optional[DeviceLoop] = None
        if self._device_sched:
            mode = device_loop or ("graph" if self.device.type == "cuda" else "eager")
            self._loop = DeviceLoop(cfg, self.params, self.cache, self.layout, lanes=max_batch,
                                    max_len=max_len, staged=max(1, staged_lanes),
                                    k_loop=self.k_loop, dispatches=self._w, seed=seed,
                                    mode=mode, device=self.device)
            # how a dispatch's outputs reach the host (a seam for tests)
            self._fetch_block = self._loop.fetch
        self.decode_collectives = 0  # collectives over the mesh during decode
        self.decode_collective_s = 0.0  # host seconds inside them
        self.kv_bytes_sum = 0  # live KV bytes a decode step reads, summed per dispatch
        self.decode_wall_s = 0.0  # decode dispatch wall time, device included
        self.sched_host_s = 0.0  # host scheduling time around dispatches
        self._itl_ms: list[float] = []
        self._last_emit: dict[int, float] = {}
        self.spec_rounds = 0  # speculative rounds (draft scan + verify pass)
        self.draft_tokens = 0  # drafts proposed
        self.verify_tokens = 0  # positions the verify passes scored
        self.accepted_draft_tokens = 0
        self.spec_emitted_tokens = 0  # tokens absorbed from rounds
        self._spec_req: dict[int, list[int]] = {}  # uid -> [drafted, accepted]

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
        """Move queued requests into free lanes, at most
        ``max_prefill_batch`` a step; one batched prefill per bucket.  A
        prompt longer than ``prefill_chunk`` takes its lane and pages now
        and is absorbed chunk by chunk (:meth:`_advance_chunks`); so is the
        uncached tail of a prefix hit, whose cached pages are mapped shared
        (LRU index entries are evicted first under pool pressure)."""
        picked: list[tuple[_Request, int, int]] = []
        n_taken = 0
        while self.queue and n_taken < self.max_prefill_batch:
            i = next((j for j, s in enumerate(self.slots) if s is None), None)
            if i is None:
                break
            req = self.queue[0]
            seq = req.prompt + req.prefix
            length = len(seq)
            chunked = self.prefill_chunk is not None and length > self.prefill_chunk
            defer = chunked and self._win_chunk  # its window pages map chunk by chunk
            shared_len, shared = 0, ()
            if self._prefix is not None:
                shared_len, shared = self._prefix.match(seq)
            if self.pool is not None:
                ok = self.pool.alloc_prefill(i, length, shared_full=shared,
                                             shared_len=shared_len, defer_win=defer)
                # an eviction can drop a matched page: match again
                while not ok and self._prefix is not None and self._prefix.evict(1):
                    shared_len, shared = self._prefix.match(seq)
                    ok = self.pool.alloc_prefill(i, length, shared_full=shared,
                                                 shared_len=shared_len, defer_win=defer)
                if not ok:
                    break  # retry next step, after frees/preemptions
            self.queue.popleft()
            n_taken += 1
            if shared_len > 0 or chunked:
                self.prefix_hits += shared_len > 0
                self.prefix_hit_tokens += shared_len
                self.slots[i] = _Slot(req, pos=shared_len, seq=self._admit_seq,
                                      pending=seq[shared_len:])
                self._admit_seq += 1
                self.admitted += 1
                continue
            self.slots[i] = _Slot(req, pos=length, seq=self._admit_seq)
            self._admit_seq += 1
            picked.append((req, i, length))
        groups: dict[int, list] = {}
        for item in picked:
            groups.setdefault(self._bucket(item[2]), []).append(item)
        for lb in sorted(groups):
            self._prefill_group(lb, groups[lb], out)

    def _prefill_group(self, lb: int, items: list, out: list) -> None:
        """One batched prefill of a bucket's ``items`` (``(request, lane,
        length)``): this rank prefills those of its own lanes (none: no
        forward), the first tokens are gathered over the data rows."""
        mine = [it for it in items if self._lo <= it[1] < self._hi]
        first = None
        if mine:
            n_real, nb = len(mine), _next_pow2(len(mine))
            tokens = np.zeros((nb, lb), np.int64)  # pad rows: zeros, never written
            lens = np.zeros((n_real,), np.int32)
            lanes = np.zeros((n_real,), np.int64)
            for r, (req, i, length) in enumerate(mine):
                tokens[r, :length] = req.prompt + req.prefix
                lens[r], lanes[r] = length, i - self._lo
            dev = self.device
            lens_t = torch.from_numpy(lens).to(dev)
            lanes_t = torch.from_numpy(lanes).to(dev)
            if self.pool is not None:
                self.pool.apply_pending()
                self.pool.device_tables()
            logits_all, produced = forward(self.params, self.cfg,
                                           torch.from_numpy(tokens).to(dev), want_cache=True)
            write_prefill(self._lane_cache, self.cfg, produced, lanes_t, lens_t, self.layout)
            logits = logits_all[torch.arange(n_real, device=dev), lens_t.long() - 1]
            first = self._first_tokens([i for _, i, _ in mine], logits)
            self.prefill_forwards += 1
        self.prefill_batches += 1
        if self._prefix is not None:
            for _, i, length in items:
                self._index_prompt(i, length)
        if self._rows_split:
            row = torch.full((self._hi - self._lo,), -1, dtype=torch.int32, device=self.device)
            if first is not None:
                row[torch.tensor([i - self._lo for _, i, _ in mine], device=self.device)] = first
            lanes_first = self._gather(row).cpu().tolist()
            host_first = [lanes_first[i] for _, i, _ in items]
        else:
            host_first = first.cpu().tolist()
        for r, (_, i, _) in enumerate(items):
            self.admitted += 1
            self._absorb(i, host_first[r], out)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """The data rows' ``x`` (last dim: their lanes) joined in lane order."""
        self.data_gathers += 1
        return sharded.gather_data(x, -1, self.mesh)

    def _index_prompt(self, lane: int, length: int) -> None:
        """Index the lane's prompt (+ resume prefix), ``length`` tokens all
        in the cache, while the lane still maps its pages."""
        s = self.slots[lane]
        full, tail = self.pool.prompt_pages(lane, length)
        self._prefix.insert(s.prompt + s.generated, full, tail, length % self.layout.page_size)

    def _first_tokens(self, lanes: list[int], logits: torch.Tensor) -> torch.Tensor:
        """Sample the first token of each of ``lanes`` (this rank's) from its
        row of ``logits`` (draw index ``len(generated)``: a resumed request
        goes on where it stopped), store it as the lane's next input and
        return them on the device."""
        slots = [self.slots[i] for i in lanes]
        dev = self.device
        temps = torch.tensor([s.sampling.temperature for s in slots], dtype=torch.float32,
                             device=dev)
        topks = torch.tensor([s.sampling.top_k for s in slots], dtype=torch.int32, device=dev)
        need_sample = any(s.sampling.temperature > 0 for s in slots)
        keys = None
        if need_sample:
            keys = draw_keys(self.seed, torch.tensor([s.uid for s in slots], device=dev),
                             torch.tensor([len(s.generated) for s in slots], device=dev))
        first = sample_tokens(logits, temps, topks, keys, need_sample=need_sample,
                              need_topk=any(s.sampling.top_k > 0 for s in slots))
        self.tokens[torch.tensor([i - self._lo for i in lanes], device=dev)] = first
        return first

    def _advance_chunks(self, out: list) -> None:
        """One chunk of every lane still absorbing its prompt, in one
        batched forward (rows padded to a power of two with sentinel lanes);
        a lane whose last chunk this was samples its first token from it.
        A windowed arch first maps each chunk's window pages, preempting the
        youngest lane on pressure.  Refilled lanes feed on the device, never
        here."""
        csz = self.prefill_chunk or self._tail_chunk
        chunking = [i for i, s in enumerate(self.slots)
                    if s is not None and s.pending and not s.feed]
        if not chunking:
            return
        if self._win_chunk and self.pool is not None:
            for i in chunking:
                s = self.slots[i]
                while (self.slots[i] is not None
                       and not self.pool.ensure_steps(i, s.pos, min(csz, len(s.pending)))):
                    self._preempt(max((j for j, t in enumerate(self.slots) if t is not None),
                                      key=lambda j: self.slots[j].seq))
            chunking = [i for i in chunking if self.slots[i] is not None]
            if not chunking:
                return
        nb = _next_pow2(len(chunking))
        toks = np.zeros((nb, csz), np.int64)
        lanes = np.full((nb,), self.max_batch, np.int64)  # the sentinel lane: a pad row
        starts = np.zeros((nb,), np.int64)
        lengths = np.zeros((nb,), np.int64)
        for r, i in enumerate(chunking):
            s = self.slots[i]
            part = s.pending[:csz]
            toks[r, :len(part)] = part
            lanes[r], starts[r], lengths[r] = i, s.pos, len(part)
        if self.pool is not None:
            self.pool.apply_pending()
            self.pool.device_tables()
        dev = self.device
        logits, _ = prefill_chunk(self.params, self.cfg, torch.from_numpy(toks).to(dev),
                                  self.cache, torch.from_numpy(lanes).to(dev),
                                  torch.from_numpy(starts).to(dev),
                                  torch.from_numpy(lengths).to(dev), self.layout)
        self.prefill_chunks += 1
        finishing = []  # (row, lane)
        for r, i in enumerate(chunking):
            s = self.slots[i]
            s.pos += int(lengths[r])
            s.pending = s.pending[int(lengths[r]):]
            if not s.pending:
                finishing.append((r, i))
        if not finishing:
            return
        if self._prefix is not None:
            # the whole prompt (+ resume prefix) is cached: index it before
            # _absorb can finish the lane
            for _, i in finishing:
                self._index_prompt(i, self.slots[i].pos)
        rows = torch.tensor([r for r, _ in finishing], device=dev)
        first = self._first_tokens([i for _, i in finishing], logits[rows]).cpu().tolist()
        for (_, i), tok in zip(finishing, first):
            self._absorb(i, tok, out)

    def _ensure_capacity(self) -> None:
        """Back every decoding lane's writes up to the horizon (K steps, or
        the device scheduler's ``k_loop × W``), oldest first; preempt the
        youngest lane on pressure."""
        if self.pool is None:
            return
        order = sorted((i for i, s in enumerate(self.slots)
                        if s is not None and (not s.pending or s.feed)),
                       key=lambda i: self.slots[i].seq)
        for i in order:
            s = self.slots[i]
            if s is None:  # evicted as an earlier lane's victim
                continue
            # a lane whose budget ends inside the horizon freezes there:
            # reserve only the writes it can reach (a refilled lane also
            # writes its prompt tokens still to feed)
            k = max(1, min(self._horizon,
                           len(s.pending) + max(1, s.sampling.max_new_tokens - len(s.generated)),
                           self.max_len - s.pos))
            while self.slots[i] is not None and not self.pool.ensure_steps(i, s.pos, k):
                # idle cached prefix pages go before a live lane does
                if self._prefix is not None and self._prefix.evict(1):
                    continue
                victim = max((j for j, t in enumerate(self.slots) if t is not None),
                             key=lambda j: self.slots[j].seq)
                self._preempt(victim)

    def _lane_inputs(self, live: list[int]) -> dict:
        """The per-lane tensors a decode dispatch or a speculative round
        reads, on the device, over this rank's lanes: ``occupied`` (a busy
        lane) and ``active`` (a lane in ``live``, decoding), the active
        lanes' ``temps`` and ``topks``, and the host flags ``need_sample``
        and ``need_topk``; with ``need_sample``, also every busy lane's
        ``uids`` and the active lanes' draw index ``counts`` (their tokens
        so far)."""
        dev, slots = self.device, self.slots[self._lo:self._hi]
        dec = [s if self._lo + j in live else None for j, s in enumerate(slots)]
        r = {
            "occupied": torch.tensor([s is not None for s in slots], device=dev),
            "active": torch.tensor([s is not None for s in dec], device=dev),
            "temps": torch.tensor([s.sampling.temperature if s else 0.0 for s in dec],
                                  dtype=torch.float32, device=dev),
            "topks": torch.tensor([s.sampling.top_k if s else 0 for s in dec],
                                  dtype=torch.int32, device=dev),
            "need_sample": any(s is not None and s.sampling.temperature > 0 for s in dec),
            "need_topk": any(s is not None and s.sampling.top_k > 0 for s in dec),
        }
        if r["need_sample"]:
            r["uids"] = torch.tensor([s.uid if s else 0 for s in slots], device=dev)
            r["counts"] = torch.tensor([len(s.generated) if s else 0 for s in dec], device=dev)
        return r

    def _decode(self, k: int) -> torch.Tensor:
        """K decode steps for every lane of this rank; returns the ``(K,
        hi - lo)`` token block of its lanes.

        Decoding lanes decode until they freeze, then keep their length, as
        lanes still absorbing their prompt do; free lanes stay pinned at
        length 0 (their writes land on the slab's row 0 or the pool's sink
        page and are never read)."""
        dev = self.device
        live = [i for i, s in enumerate(self.slots) if s is not None and not s.pending]
        r = self._lane_inputs(live)
        dec = [self.slots[i] if i in live else None for i in range(self._lo, self._hi)]
        eos = torch.tensor([s.sampling.eos_id if s else -1 for s in dec],
                           dtype=torch.int32, device=dev)
        budget = torch.tensor(
            [s.sampling.max_new_tokens - len(s.generated) if s else 0 for s in dec],
            dtype=torch.int32, device=dev)
        occupied, active, need_sample = r["occupied"], r["active"], r["need_sample"]
        # a lane's draw index: its tokens so far, + 1 for each step it stays
        # active (a frozen lane's draw is discarded by advance_stops)
        counts = r.get("counts")
        tok, cache, block = self.tokens, self._lane_cache, []
        for t in range(k):
            len_prev = cache["len"].clone()
            logits, cache = decode_step(self.params, self.cfg, tok, cache, self.layout)
            cache["len"].copy_(torch.where(active, cache["len"],
                                           torch.where(occupied, len_prev, 0)))
            keys = None
            if need_sample:
                keys = draw_keys(self.seed, r["uids"], counts)
                counts = counts + active.long()
            nxt = sample_tokens(logits, r["temps"], r["topks"], keys,
                                need_sample=need_sample, need_topk=r["need_topk"])
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
        """Admit, reserve, run one K-step decode dispatch (one device
        scheduler cycle); return the requests that finished."""
        with self._mesh_ctx():
            if self._spec:
                return self._step_spec()
            return self._step_device() if self._device_sched else self._step()

    def _prepare_dispatch(self, out: list) -> Optional[tuple[list[int], float]]:
        """A sync dispatch's prologue, a decode dispatch's and a speculative
        round's: admission and chunks, pages for the horizon's writes, the
        pending copies and the page tables; returns ``(the live lanes, the
        scheduler's start time)``, or None when no lane decodes."""
        self._admit(out)
        if self.prefill_chunk is not None or self._prefix is not None:
            self._advance_chunks(out)
        t_sched0 = time.perf_counter()
        self._ensure_capacity()
        live = [i for i, s in enumerate(self.slots) if s is not None and not s.pending]
        self.max_concurrency = max(self.max_concurrency, len(live))
        if not live:
            return None
        if self.pool is not None:
            self.pool.apply_pending()
            self.pool.device_tables()
        self.kv_bytes_sum += self.live_kv_bytes()
        return live, t_sched0

    def _absorb_block(self, live: list[int], block: np.ndarray, out: list,
                      lengths: Optional[np.ndarray] = None) -> int:
        """Absorb a dispatch's ``(T, B)`` host block step by step: lane ``i``
        of ``live`` takes its first ``lengths[i]`` tokens (all ``T`` without
        ``lengths``), its ``pos`` mirroring ``cache["len"]``; a stop
        mid-block drops the lane's rest.  Returns the tokens absorbed."""
        live, n = list(live), 0
        for t in range(block.shape[0]):
            for i in list(live):
                if lengths is not None and t >= lengths[i]:
                    live.remove(i)
                    continue
                self.slots[i].pos += 1
                self._absorb(i, int(block[t, i]), out, from_decode=True)
                n += 1
                if self.slots[i] is None:
                    live.remove(i)
        return n

    def _step(self) -> list[GenerationResult]:
        out: list[GenerationResult] = []
        ready = self._prepare_dispatch(out)
        if ready is None:
            return out
        live, t_sched0 = ready
        k = self.steps_per_dispatch
        t0 = time.perf_counter()
        c0, s0 = sharded.collectives, sharded.collective_s
        block = self._decode(k)
        if self._rows_split:
            block = self._gather(block)  # (K, B): every row's lanes
        host_block = block.cpu().numpy()  # one host sync per K tokens
        t1 = time.perf_counter()
        self.decode_collectives += sharded.collectives - c0
        self.decode_collective_s += sharded.collective_s - s0
        self.decode_wall_s += t1 - t0
        self.decode_steps += k
        self.dispatches += 1
        self.block_fetches += 1
        self._absorb_block(live, host_block, out)
        self.sched_host_s += (t0 - t_sched0) + (time.perf_counter() - t1)
        return out

    # -- speculative decoding ------------------------------------------------

    @staticmethod
    def pick_spec_gamma(draft_bytes: int, verify_bytes: int) -> int:
        """The draft length for ``spec_gamma="auto"`` (the reference's
        roofline): a round moves ``g`` drafter sweeps and one verifier sweep
        and commits ``(1 - a^(g+1)) / (1 - a)`` tokens at an i.i.d.
        acceptance ``a`` = ``SPEC_ALPHA``; the ``g`` in ``1..SPEC_G_MAX``
        with the fewest bytes per committed token."""
        a = SPEC_ALPHA
        best_g, best_cost = 1, float("inf")
        for g in range(1, SPEC_G_MAX + 1):
            cost = (g * draft_bytes + verify_bytes) / ((1.0 - a ** (g + 1)) / (1.0 - a))
            if cost < best_cost:
                best_g, best_cost = g, cost
        return best_g

    def _draft(self, r: dict) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The draft scan over a round's inputs ``r`` (:meth:`_lane_inputs`
        with ``gi``, ``steps`` = max(gi) and ``len0``, the lanes' lengths at
        the round's start): ``steps`` decode steps under the drafter, lane
        ``i`` proposing in its first ``gi[i]`` of them; returns ``(drafts
        (B, G), the drafter's filtered probs (B, G, V) or None when every
        lane is greedy)``, zero past each lane's ``gi``.  ``len`` returns to
        the round's start: the verify pass rewrites every drafted slot."""
        b, g, cache = self.max_batch, self.spec_gamma, self.cache
        gi, occupied, need_sample = r["gi"], r["occupied"], r["need_sample"]
        drafts = torch.zeros((b, g), dtype=torch.int32, device=self.device)
        dprobs = (torch.zeros((b, g, self.cfg.vocab), device=self.device) if need_sample
                  else None)
        tok, counts = self.tokens, r.get("counts")
        for t in range(r["steps"]):
            drafting = t < gi
            len_prev = cache["len"].clone()
            logits, cache = decode_step(self._draft_params, self.cfg, tok, cache, self.layout)
            cache["len"].copy_(torch.where(drafting, cache["len"],
                                           torch.where(occupied, len_prev, 0)))
            keys = None
            if need_sample:
                keys = draw_keys(self.seed, r["uids"], counts, tag=1)
                counts = counts + drafting.long()
            nxt = sample_tokens(logits, r["temps"], r["topks"], keys, need_sample=need_sample,
                                need_topk=r["need_topk"])
            nxt = torch.where(drafting, nxt, 0)
            if need_sample:
                probs = filtered_probs(logits, r["temps"], r["topks"], need_topk=r["need_topk"])
                dprobs[:, t] = torch.where(drafting[:, None], probs, 0.0)
            tok = torch.where(drafting, nxt, tok)
            drafts[:, t] = nxt
        cache["len"].copy_(torch.where(occupied, r["len0"], 0))
        return drafts, dprobs

    def _verify(self, r: dict, drafts: torch.Tensor,
                dprobs: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """The verify pass: one chunk of every live lane's ``[last token,
        drafts]`` through the verifier at its committed length (inactive
        lanes are pad rows), the accept rule, and the rewind of ``len`` to
        the accepted prefix plus the trailing token's input slot; returns
        ``(tokens (B, G+1), n_acc (B,))`` and leaves each lane's next input
        in ``self.tokens``."""
        b, g, dev = self.max_batch, self.spec_gamma, self.device
        active, gi = r["active"], r["gi"]
        rows = torch.cat([self.tokens[:, None], drafts], dim=1).long()
        lanes = torch.where(active, torch.arange(b, device=dev), b)
        lengths = torch.where(active, gi + 1, 0)
        logits, _ = prefill_chunk(self.params, self.cfg, rows, self.cache, lanes,
                                  r["len0"].long(), lengths, self.layout, all_logits=True)
        temps = r["temps"][:, None].expand(b, g + 1)
        topks = r["topks"][:, None].expand(b, g + 1)
        p_ver = filtered_probs(logits, temps, topks, need_topk=r["need_topk"])
        akeys = rkeys = None
        if r["need_sample"]:
            akeys = draw_keys(self.seed, r["uids"], r["counts"], tag=2)
            rkeys = draw_keys(self.seed, r["uids"], r["counts"], tag=3)
        block, n_acc = spec_accept(drafts, dprobs, p_ver, gi, akeys, rkeys,
                                   need_sample=r["need_sample"])
        block = torch.where(active[:, None], block, 0)
        n_acc = torch.where(active, n_acc, 0)
        # committed: the accepted drafts and the input they followed; the
        # trailing token's K/V is written next round
        self.cache["len"].copy_(torch.where(active, r["len0"] + n_acc + 1, self.cache["len"]))
        last = block.gather(1, n_acc.long()[:, None])[:, 0]
        self.tokens = torch.where(active, last, self.tokens)
        return block, n_acc

    def _step_spec(self) -> list[GenerationResult]:
        """One speculative round (module docstring): admission and chunks,
        pages for the round's ``gamma + 1`` writes, the draft scan and the
        verify pass, one host read of the accepted block, the stop rules,
        then each live lane's pages rolled back to its length."""
        out: list[GenerationResult] = []
        ready = self._prepare_dispatch(out)  # the horizon covers the round's writes
        if ready is None:
            return out
        live, t_sched0 = ready
        gi = np.zeros((self.max_batch,), np.int64)
        for i in live:
            s = self.slots[i]
            # a lane with one token of budget or room left drafts nothing and
            # still finishes through the verify pass's token
            gi[i] = max(0, min(self.spec_gamma, self.max_len - 1 - s.pos,
                               s.sampling.max_new_tokens - len(s.generated) - 1))
        t0 = time.perf_counter()
        r = self._lane_inputs(live)
        r.update(gi=torch.from_numpy(gi).to(self.device), steps=int(gi.max()),
                 len0=self.cache["len"].clone())
        block, n_acc = self._verify(r, *self._draft(r))
        host = torch.cat([block, n_acc[:, None]], dim=1).cpu().numpy()  # the round's one sync
        t1 = time.perf_counter()
        self.decode_wall_s += t1 - t0
        self.decode_steps += r["steps"] + 1
        self.dispatches += 2  # the draft scan and the verify pass
        self.spec_rounds += 1
        self.block_fetches += 1
        for i in live:
            n, gii = int(host[i, -1]), int(gi[i])
            self.draft_tokens += gii
            self.verify_tokens += gii + 1
            self.accepted_draft_tokens += n
            rec = self._spec_req.setdefault(self.slots[i].uid, [0, 0])
            rec[0] += gii
            rec[1] += n
        self.spec_emitted_tokens += self._absorb_block(live, host[:, :-1].T, out, host[:, -1] + 1)
        if self.pool is not None:
            for i in live:  # finished lanes were released whole
                if self.slots[i] is not None:
                    self.pool.rollback(i, self.slots[i].pos)
        self.sched_host_s += (t0 - t_sched0) + (time.perf_counter() - t1)
        return out

    # -- device-resident scheduler -------------------------------------------

    def _stage_fill(self) -> None:
        """Stage up to ``staged_lanes`` queued prompts for refills inside the
        loop, each with its pages for the write horizon reserved
        (``PagedKVPool.stage_alloc``); staging stops at the first the pool
        cannot back.  What the loop does not consume goes back to the queue
        at the cycle's end (:meth:`_unstage`)."""
        while len(self._staged) < self.staged_lanes and self.queue:
            req = self.queue[0]
            seq = req.prompt + req.prefix
            rec = None
            if self.pool is not None:
                rec = self.pool.stage_alloc(len(seq), req.sampling.max_new_tokens
                                            - len(req.prefix), self._horizon)
                if rec is None:
                    break
            self.queue.popleft()
            self._staged.append({"req": req, "rec": rec, "len": len(seq),
                                 "tokens": np.pad(np.asarray(seq, np.int32),
                                                  (0, self.max_len - len(seq)))})

    def _unstage(self, skip: int = 0) -> None:
        """Return the staged entries from ring row ``skip`` on to the queue's
        front, their pages released."""
        rest, self._staged = self._staged[skip:], []
        for e in reversed(rest):
            if e["rec"] is not None:
                self.pool.release_staged(e["rec"])
            self.queue.appendleft(e["req"])

    def _build_dstate(self) -> None:
        """The loop's inputs, rebuilt from host bookkeeping every cycle and
        copied to the device (the host reads back only each dispatch's
        token block and refill records)."""
        b, q = self.max_batch, max(1, self.staged_lanes)
        lanes = np.zeros((len(LANE_ROWS), b), np.int32)
        row = {name: lanes[r] for r, name in enumerate(LANE_ROWS)}
        row["eos"][:] = -1
        temps = np.zeros((b,), np.float32)
        feed_buf = np.zeros((b, self.max_len), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            # a lane still absorbing chunks on the host is occupied, not
            # live: its length holds
            row["occupied"][i], row["live"][i] = 1, int(not s.pending or s.feed)
            row["uids"][i], row["topks"][i] = s.uid, s.sampling.top_k
            row["eos"][i], temps[i] = s.sampling.eos_id, s.sampling.temperature
            row["counts"][i] = len(s.generated)
            row["budget"][i] = max(0, s.sampling.max_new_tokens - len(s.generated))
            if s.generated:
                row["tok"][i] = s.generated[-1]
            if s.pending and s.feed:  # a refill still feeding: its unfed tail goes on
                feed_buf[i, :len(s.pending)] = s.pending
                row["pend"][i] = len(s.pending)
        ring = np.zeros((len(RING_ROWS), q), np.int32)
        ring[RING_ROWS.index("eos")] = -1
        s_temps = np.zeros((q,), np.float32)
        s_tokens = np.zeros((q, self.max_len), np.int32)
        for r, e in enumerate(self._staged):
            sp = e["req"].sampling
            ring[:, r] = (e["len"], e["req"].uid, len(e["req"].prefix), sp.top_k, sp.eos_id,
                          max(1, sp.max_new_tokens - len(e["req"].prefix)))
            s_temps[r], s_tokens[r] = sp.temperature, e["tokens"]
        tables = {}
        for key in self._loop.table_keys:
            t = np.full((q, self.pool.cache["tables"][key].shape[1]), self.layout.sentinel,
                        np.int32)
            for r, e in enumerate(self._staged):
                t[r] = e["rec"][f"{key}_row"]
            tables[f"s_tbl_{key}"] = t
        self._loop.load(lanes=lanes, temps=temps, feed_buf=feed_buf, ring=ring,
                        s_temps=s_temps, s_tokens=s_tokens, scal=(0, len(self._staged), 1),
                        **tables)

    def _replay(self, hb: np.ndarray, steps: int, c_lane: np.ndarray, c_step: np.ndarray,
                out: list) -> int:
        """Mirror one dispatch on the host: advance positions, absorb the
        sampled tokens through the stop rules the device applied, install
        the refills at the iterations the device made them.  Returns the
        ring rows this dispatch consumed."""
        by_step: dict[int, list[int]] = {}
        for r in range(c_lane.shape[0]):
            if c_step[r] >= 0:
                by_step.setdefault(int(c_step[r]), []).append(r)
        for t in range(steps):
            # a lane chunking on the host held still on the device
            busy = [i for i, s in enumerate(self.slots)
                    if s is not None and (not s.pending or s.feed)]
            feeders = [i for i in busy if self.slots[i].pending and self.slots[i].feed]
            for i in busy:
                self.slots[i].pos += 1  # mirror cache["len"] advancing
            for i in feeders:
                s = self.slots[i]
                s.pending.pop(0)
                if not s.pending:  # the drain step sampled the first token
                    self._absorb(i, int(hb[t, i]), out)
            for i in busy:
                if i not in feeders:
                    self._absorb(i, int(hb[t, i]), out, from_decode=True)
            for r in by_step.get(t, ()):
                # the loop put ring row r into a dead lane at the end of
                # iteration t; it feeds from t + 1
                lane, e = int(c_lane[r]), self._staged[r]
                if self.slots[lane] is not None:
                    raise RuntimeError(f"the device refilled lane {lane}, which the host "
                                       "holds busy")
                if e["rec"] is not None:
                    self.pool.adopt_staged(lane, e["rec"])
                req = e["req"]
                self.slots[lane] = _Slot(req, pos=0, seq=self._admit_seq,
                                         pending=req.prompt + req.prefix, feed=True)
                self._admit_seq += 1
                self.admitted += 1
                self.refills += 1
        return sum(len(v) for v in by_step.values())

    def _step_device(self) -> list[GenerationResult]:
        """One device-scheduler cycle: admission, reservation to the
        horizon, staging and the loop's state (the cycle's one host sync),
        then W dispatches launched back to back, fetched and replayed in
        launch order."""
        out: list[GenerationResult] = []
        self._admit(out)
        if self.prefill_chunk is not None or self._prefix is not None:
            # drain every prompt chunking on the host before the cycle: such
            # a lane cannot join the loop, and a chunk a cycle would starve
            # it; stop where a pass makes no progress (pool pressure)
            todo = self._chunk_tokens()
            while todo:
                self._advance_chunks(out)
                left = self._chunk_tokens()
                if left >= todo:
                    break
                todo = left
        t_sched0 = time.perf_counter()
        self._ensure_capacity()
        self._stage_fill()
        live = sum(s is not None and (not s.pending or s.feed) for s in self.slots)
        self.max_concurrency = max(self.max_concurrency, live)
        if not live and not self._staged:
            return out
        self.kv_bytes_sum += self.live_kv_bytes()
        if self.pool is not None:
            self.pool.apply_pending()  # in place, before any replay reads the pages
            self.pool.device_tables()
        self._build_dstate()
        sampling = [s.sampling for s in self.slots if s is not None]
        sampling += [e["req"].sampling for e in self._staged]
        sig = (self.k_loop, any(sp.temperature > 0 for sp in sampling),
               any(sp.top_k > 0 for sp in sampling))
        t_capture = time.perf_counter()
        self._loop.prepare(sig)  # a new signature's capture: not decode, not scheduling
        t0 = time.perf_counter()
        for w in range(self._w):  # the state chains on the device
            self._loop.dispatch(w, sig)
        self.dispatches += self._w
        t_launched = time.perf_counter()
        consumed, fetch_s, host_s = 0, 0.0, 0.0
        for w in range(self._w):
            f0 = time.perf_counter()
            hb, steps, c_lane, c_step = self._fetch_block(w)
            f1 = time.perf_counter()
            self.block_fetches += 1
            self.decode_steps += steps
            consumed += self._replay(hb, steps, c_lane, c_step, out)
            host_s += time.perf_counter() - f1
            fetch_s += f1 - f0
        self.decode_wall_s += (t_launched - t0) + fetch_s
        self._unstage(skip=consumed)
        self.cycles += 1
        self.sched_host_s += (t_capture - t_sched0) + host_s
        return out

    def _chunk_tokens(self) -> int:
        """Prompt tokens the host still has to absorb chunk by chunk."""
        return sum(len(s.pending) for s in self.slots
                   if s is not None and s.pending and not s.feed)

    def run(self) -> dict[int, GenerationResult]:
        """Drain the queue and every busy lane; results keyed by uid."""
        results: dict[int, GenerationResult] = {}
        while self.queue or any(s is not None for s in self.slots):
            for r in self.step():
                results[r.uid] = r
        return results

    # -- reporting -----------------------------------------------------------

    def kv_cache_bytes(self) -> int:
        """Device bytes of the serving cache, summed over every layer's
        leaves: the attention and MLA storage (slab, or pool with its sink
        page) and the RG-LRU and SSM states of every lane (an attention-free
        arch's whole cache)."""
        return sum(t.numel() * t.element_size()
                   for _, path, _ in self._mixers
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
        """Which paged-attention implementation decode runs: ``"slab"`` on
        the slab, ``"none"`` on the pool of an arch without attention, else ``"cuda"`` (the kernel) or ``"plain"`` (CPU tensors),
        prefixed ``"shard_map/"`` (the reference's name of the route) where
        a pages-sharded pool runs the stats form and the combine."""
        if self.pool is None:
            return "slab"
        if not self.cache["tables"]:  # an attention-free arch's pool
            return "none"
        inner = "cuda" if self.device.type == "cuda" else "plain"
        return f"shard_map/{inner}" if self.layout.shards > 1 else inner

    def stats(self) -> dict:
        """Throughput counts decode-produced tokens over decode wall time;
        each request's first token comes from prefill and is excluded."""
        steps = self.decode_steps
        total_wall = self.decode_wall_s + self.sched_host_s
        # a host sync is where scheduling happens: each dispatch of the sync
        # scheduler, each cycle of the device scheduler (so is the KV read
        # sampled)
        syncs = (self.cycles if self._device_sched
                 else self.spec_rounds if self._spec else self.dispatches)
        st = {
            "layout": self.layout.kind,
            "scheduler": "device" if self._device_sched else "sync",
            "decode_steps": steps,
            "dispatches": self.dispatches,
            "steps_per_dispatch": self.steps_per_dispatch,
            "host_syncs": syncs,
            "cycles": self.cycles,
            "block_fetches": self.block_fetches,
            "refills": self.refills,
            "max_steps_per_dispatch": self.k_loop,
            "staged_lanes": self.staged_lanes,
            "async_stream": self.async_stream,
            "itl_ms_p50": float(np.percentile(self._itl_ms, 50)) if self._itl_ms else 0.0,
            "itl_ms_p99": float(np.percentile(self._itl_ms, 99)) if self._itl_ms else 0.0,
            "admitted": self.admitted,
            "preemptions": self.preemptions,
            "max_concurrency": self.max_concurrency,
            "prefill_batches": self.prefill_batches,
            "prefill_chunks": self.prefill_chunks,
            "lanes": [self._lo, self._hi],
            "prefill_forwards": self.prefill_forwards,
            "data_gathers": self.data_gathers,
            "tokens_generated": self.tokens_generated,
            "decode_tokens": self.decode_tokens,
            "decode_wall_s": self.decode_wall_s,
            "sched_host_s": self.sched_host_s,
            "kv_cache_bytes": self.kv_cache_bytes(),
            "kv_bytes_per_step": self.kv_bytes_sum / syncs if syncs else 0.0,
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
        if self._loop is not None:
            # iterations the loop ran on the device (a gated one commits
            # nothing but runs its kernels), the captures' warm-ups and
            # their host seconds
            st.update(device_loop=self._loop.mode, loop_iterations=self._loop.iterations,
                      gated_iterations=self._loop.iterations - steps,
                      warmup_iterations=self._loop.warmup_iterations,
                      capture_s=self._loop.capture_s)
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
                shared_pages=self.pool.shared_pages,
                cow_copies=self.pool.cow_copies,
            )
        if self._spec:
            w_d, w_v = self._spec_draft_bytes, self._spec_verify_bytes
            st.update(
                spec_gamma=self.spec_gamma,
                spec_rounds=self.spec_rounds,
                draft_tokens=self.draft_tokens,
                verify_tokens=self.verify_tokens,
                accepted_draft_tokens=self.accepted_draft_tokens,
                spec_emitted_tokens=self.spec_emitted_tokens,
                acceptance_rate=(self.accepted_draft_tokens / self.draft_tokens
                                 if self.draft_tokens else 0.0),
                accepted_per_verify=(self.spec_emitted_tokens / self.spec_rounds
                                     if self.spec_rounds else 0.0),
                draft_weight_bytes_per_step=w_d,
                verify_weight_bytes_per_step=w_v,
                # each round streams gamma drafter sweeps and one verifier sweep
                bytes_per_accepted_token=(self.spec_rounds * (self.spec_gamma * w_d + w_v)
                                          / self.spec_emitted_tokens
                                          if self.spec_emitted_tokens else 0.0),
                spec_per_request={uid: {"drafted": d, "accepted": a,
                                        "acceptance_rate": a / d if d else 0.0}
                                  for uid, (d, a) in sorted(self._spec_req.items())},
            )
        if self._prefix is not None:
            st.update(
                prefix_cache=True,
                prefix_indexed_pages=self._prefix.pages,
                prefix_evictions=self._prefix.evictions,
                prefix_hits=self.prefix_hits,
                prefix_hit_tokens=self.prefix_hit_tokens,
                prefix_hit_rate=self.prefix_hits / self.admitted if self.admitted else 0.0,
            )
        return st

"""Radix prompt index over refcounted KV pages (counterpart of
``repro/serving/prefix_cache.py``; pure Python, a copy of its own).

``PrefixIndex`` maps token prefixes to the pool pages that already hold
their KV, at page granularity: each trie edge is one *full* page of
``page_size`` prompt tokens (keyed by the exact token tuple), and a node
may also carry *partial* entries, tail pages whose first ``n_valid <
page_size`` slots hold prompt KV.  Admission asks :meth:`PrefixIndex.match`
for a new prompt's longest cached prefix; the engine maps the hit pages
into the lane's table (``PagedKVPool.alloc_prefill(shared_full=...)``)
and chunk-prefills only the uncached tail.

Every indexed page carries one pool reference (``add_ref`` on insert,
``decref`` on evict), so indexed KV stays resident after the request that
wrote it finishes.  Sharing is read-only: a lane that must write into a
matched partial page forks it in the pool (copy-on-write), and so does
the owner of an indexed partial page at its first decode write; the index
never sees a page change.

A match covers at most ``len(prompt) - 1`` tokens: one prompt token at
least runs through the model, so the first sampled token has logits.
``evict`` drops least-recently-used leaves first (partial entries, then
childless full nodes) and reports how many pages went back to the free
list (an entry whose page a live lane still holds frees nothing yet).
"""
from __future__ import annotations

from typing import Optional, Sequence


class _Node:
    """One full page of cached prompt: ``toks`` (page_size tokens) → pid."""

    __slots__ = ("pid", "toks", "children", "partials", "parent", "last_used")

    def __init__(self, pid: int, toks: tuple, parent: "Optional[_Node]"):
        self.pid = pid
        self.toks = toks
        self.children: dict[tuple, _Node] = {}
        self.partials: list[_Partial] = []
        self.parent = parent
        self.last_used = 0


class _Partial:
    """A tail page: only the first ``len(toks)`` slots hold prompt KV."""

    __slots__ = ("pid", "toks", "last_used")

    def __init__(self, pid: int, toks: tuple):
        self.pid = pid
        self.toks = toks
        self.last_used = 0


class PrefixIndex:
    def __init__(self, pool, page_size: int):
        self.pool = pool
        self.ps = page_size
        self.root = _Node(-1, (), None)
        self._tick = 0
        self.pages = 0  # entries currently indexed (== pool refs held)
        self.lookups = 0
        self.hits = 0  # lookups that matched >= 1 page
        self.hit_tokens = 0
        self.evictions = 0  # entries dropped by evict()

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        while node is not None:
            node.last_used = self._tick
            node = node.parent

    # -- lookup --------------------------------------------------------------

    def match(self, prompt: Sequence[int]) -> tuple[int, tuple[int, ...]]:
        """Longest cached prefix of ``prompt``: ``(matched_len, page_ids)``.

        ``page_ids`` back logical full-table pages ``0..len(page_ids)-1``;
        when ``matched_len % page_size != 0`` the last id is a partial
        entry (the caller copy-on-write forks it before writing its tail).
        """
        self.lookups += 1
        prompt = tuple(prompt)
        cap = len(prompt) - 1  # >= 1 token must prefill for first logits
        node, pids, matched = self.root, [], 0
        while matched + self.ps <= cap:
            child = node.children.get(prompt[matched:matched + self.ps])
            if child is None:
                break
            node = child
            pids.append(child.pid)
            matched += self.ps
        best: Optional[_Partial] = None
        for p in node.partials:
            n = len(p.toks)
            if matched + n <= cap and prompt[matched:matched + n] == p.toks:
                if best is None or n > len(best.toks):
                    best = p
        if best is not None:
            self._tick += 1
            best.last_used = self._tick
            pids.append(best.pid)
            matched += len(best.toks)
        if pids:
            self._touch(node)
            self.hits += 1
            self.hit_tokens += matched
        return (matched, tuple(pids)) if pids else (0, ())

    # -- insertion -----------------------------------------------------------

    def insert(self, prompt: Sequence[int], full_pids: Sequence[int],
               partial_pid: Optional[int], partial_len: int) -> None:
        """Index a fully-prefilled prompt's pages.

        ``full_pids[i]`` backs prompt tokens ``[i*ps, (i+1)*ps)``;
        ``partial_pid`` (if given) holds the trailing ``partial_len``
        tokens.  Pages already indexed (a forked lane re-inserting its
        shared prefix, or a duplicate prompt racing in) are skipped — the
        first entry wins and keeps its single reference."""
        prompt = tuple(prompt)
        node = self.root
        for i, pid in enumerate(full_pids):
            key = prompt[i * self.ps:(i + 1) * self.ps]
            child = node.children.get(key)
            if child is None:
                self.pool.add_ref(pid)
                child = _Node(pid, key, node)
                node.children[key] = child
                self.pages += 1
            node = child
        self._touch(node)
        if partial_pid is None or partial_len <= 0:
            return
        toks = prompt[len(full_pids) * self.ps:
                      len(full_pids) * self.ps + partial_len]
        for key in node.children:
            if key[:partial_len] == toks:
                return  # a full page already covers these tokens
        for p in node.partials:
            if len(p.toks) >= partial_len and p.toks[:partial_len] == toks:
                p.last_used = self._tick
                return  # an equal-or-longer partial subsumes the new one
        # the new entry dominates any shorter partial it extends
        for p in list(node.partials):
            if toks[:len(p.toks)] == p.toks:
                node.partials.remove(p)
                self.pool.decref(p.pid)
                self.pages -= 1
                self.evictions += 1
        self.pool.add_ref(partial_pid)
        p = _Partial(partial_pid, toks)
        p.last_used = self._tick
        node.partials.append(p)
        self.pages += 1

    # -- eviction ------------------------------------------------------------

    def _leaves(self) -> list[tuple]:
        """Evictable entries: ``(last_used, parent, partial, full_node)``
        with exactly one of partial / full_node set."""
        out: list[tuple] = []

        def walk(node: _Node):
            for p in node.partials:
                out.append((p.last_used, node, p, None))
            for c in node.children.values():
                if not c.children and not c.partials:
                    out.append((c.last_used, node, None, c))
                else:
                    walk(c)

        walk(self.root)
        return out

    def evict(self, want_free: int = 1) -> int:
        """Drop LRU leaf entries until ``want_free`` pages actually
        returned to the free list (or the index is empty); returns the
        number freed.  Dropping an entry whose page a live lane still
        references releases the index's pin without freeing — progress is
        still made, because the next drop candidates surface."""
        freed = 0
        while freed < want_free:
            leaves = self._leaves()
            if not leaves:
                break
            leaves.sort(key=lambda e: e[0])
            dropped_any = False
            for _, parent, part, full in leaves:
                if freed >= want_free:
                    break
                if full is not None:  # childless full node
                    del parent.children[full.toks]
                    pid = full.pid
                else:
                    parent.partials.remove(part)
                    pid = part.pid
                before = self.pool.free_pages
                self.pool.decref(pid)
                freed += self.pool.free_pages - before
                self.pages -= 1
                self.evictions += 1
                dropped_any = True
            if not dropped_any:
                break
        return freed

    def clear(self) -> None:
        """Drop every entry (and its pool reference)."""
        def walk(node: _Node):
            for p in node.partials:
                self.pool.decref(p.pid)
                self.pages -= 1
            node.partials = []
            for c in list(node.children.values()):
                walk(c)
                self.pool.decref(c.pid)
                self.pages -= 1
            node.children = {}

        walk(self.root)

"""Shared-prefix KV cache: a refcounted radix tree over the paged pool.

A copy of ``repro.serving.prefix_cache`` (numpy only, host bookkeeping), so
the port imports nothing of the JAX package.

The paged pool already allows many-to-one page mapping — nothing in
``PageState.table`` says two slots may not point at the same physical page.
This module is the index that makes that safe and useful: requests that
share a prompt prefix (a tenant's system prompt, a few-shot preamble) map
the *same* physical pages read-only and prefill only their divergent tail —
the paper's two-stage discipline applied to serving state: the heavy static
artifact (the cached prefix pages) is reused, only the cheap dynamic part
(the suffix) is recompiled per request.

Structure
---------
A radix/trie at **page granularity**: one node per full page of prompt
tokens, keyed by that page's token tuple, so a root-to-node path spells a
page-aligned token prefix.  Trees are per **namespace** (a tenant, or a
namespace several tenants agree to share) — lookups never cross
namespaces, which is the isolation rule: sharing is opt-in by key.

Lifecycle discipline (who may recycle a page, and when):

* a node's ``page_id`` is a physical page of the tenant's
  :class:`~repro_torch.serving.kv_cache.PagedKVPool`; while the node lives, the
  page is **off the device free stack** and billed once to the namespace
  (``PagedKVPool.share``);
* ``refcount`` counts requests currently mapping the page.  Admission
  :meth:`acquire`\\ s the hit path, completion/OOM-requeue
  :meth:`release`\\ s it.  A page is *recyclable only at refcount 0* — and
  even then it stays cached (its contents are the cache's value) until
  eviction;
* eviction is **LRU over unpinned leaf nodes**: pinned means
  ``refcount > 0`` anywhere below, leaf means no children (an interior
  node is unreachable-from-root once removed, so subtrees fall leaf-first);
* a **partially-filled last page is never shared**: only full pages are
  indexed, and the caller additionally caps the shareable prefix at
  ``(prompt_len - 1) // page_size`` pages so the page holding the last
  prompt token — the one a divergent continuation would write — is always
  private (copy-on-write by construction: shared pages are read-only, the
  divergent tail gets freshly-popped pages).

The tree is pure host bookkeeping (no tensors): physical ids flow in from the
admission program's returned table rows and flow out to the device only
through the batcher's eviction pushes.

Known limitation — **prompt-length alignment**: the batcher left-pads every
prompt to its ``prompt_len`` bucket, and cache keys (like RoPE positions)
are taken over the padded row.  Two prompts therefore share pages only when
their *total* lengths are equal — a shared system preamble followed by
tails of different lengths lands at different absolute positions and can
never hit.  Templated clients should pad their tails to a fixed length (or
the batcher's bucket should move to right-aligned prompts + per-request
position offsets).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

Key = Tuple[int, ...]


@dataclasses.dataclass
class PrefixNode:
    """One full page of a cached prompt prefix."""

    key: Key                         # this page's page_size tokens
    page_id: int                     # physical pool page holding its K/V
    namespace: Hashable
    parent: Optional["PrefixNode"]
    children: Dict[Key, "PrefixNode"] = dataclasses.field(default_factory=dict)
    refcount: int = 0                # requests currently mapping the page
    last_used: int = 0               # LRU tick (lookup hit or release)

    @property
    def depth(self) -> int:
        """Logical page index this node backs (root children are page 0)."""
        d, n = 0, self.parent
        while n is not None:
            d, n = d + 1, n.parent
        return d

    def __repr__(self) -> str:  # compact, for test failures
        return (f"<page {self.page_id} depth {self.depth} "
                f"rc {self.refcount} ns {self.namespace!r}>")


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0                    # lookups that matched >= 1 page
    hit_pages: int = 0               # total pages served from the cache
    inserts: int = 0                 # nodes created
    evictions: int = 0               # nodes evicted (pages returned)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)


class PrefixCache:
    """Namespace-keyed radix tree of cached prompt-prefix pages."""

    def __init__(self, page_size: int) -> None:
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self._roots: Dict[Hashable, Dict[Key, PrefixNode]] = {}
        self._tick = itertools.count(1)
        self.n_pages = 0             # live nodes == cached pages
        self.stats = PrefixCacheStats()
        # ghost index: page-path keys of prompts looked up before, WITHOUT
        # pages behind them — recurrence evidence for the insert heuristic
        # (indexing every single-use tail would evict useful entries)
        self._seen: "OrderedDict[Tuple[Hashable, int, bytes], bool]" = \
            OrderedDict()
        self.seen_cap = 4096

    # -- keys -----------------------------------------------------------
    def _page_keys(self, tokens: Sequence[int]) -> List[Key]:
        """Full-page token tuples of a (padded) prompt row."""
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        return [tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
                for i in range(len(toks) // ps)]

    def max_shareable(self, prompt_len: int) -> int:
        """Pages of a ``prompt_len`` prompt that may ever be shared: the
        page holding the last token stays private (COW tail)."""
        return max(0, (int(prompt_len) - 1) // self.page_size)

    # -- lookup / pin ---------------------------------------------------
    def lookup(self, namespace: Hashable, tokens: Sequence[int],
               *, max_pages: Optional[int] = None) -> List[PrefixNode]:
        """Longest cached page path for ``tokens`` in ``namespace`` (at most
        ``max_pages`` — callers pass :meth:`max_shareable`).  Stamps the
        path's LRU ticks.  Returns the node path, root-child first."""
        keys = self._page_keys(tokens)
        if max_pages is None:
            max_pages = self.max_shareable(len(np.asarray(tokens).reshape(-1)))
        keys = keys[:max(0, int(max_pages))]
        level = self._roots.get(namespace, {})
        path: List[PrefixNode] = []
        tick = next(self._tick)
        for key in keys:
            node = level.get(key)
            if node is None:
                break
            node.last_used = tick
            path.append(node)
            level = node.children
        self.stats.lookups += 1
        if path:
            self.stats.hits += 1
            self.stats.hit_pages += len(path)
        return path

    def note_seen(self, namespace: Hashable, tokens: Sequence[int],
                  *, max_pages: Optional[int] = None) -> int:
        """Ghost index: record this prompt's page paths and return how many
        *leading* pages had already been seen by an earlier call — the
        "this prefix recurs" evidence the batcher needs before spending
        cache pages on it (a prefix only ever seen once is a tail, and
        indexing tails evicts entries that would actually hit).  Bounded
        LRU over ``seen_cap`` keys; keys only, no pages held."""
        toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
        ps = self.page_size
        if max_pages is None:
            max_pages = self.max_shareable(len(toks))
        keys = [(namespace, i, toks[:(i + 1) * ps].tobytes())
                for i in range(max(0, int(max_pages)))]
        depth = 0
        for key in keys:
            if key not in self._seen:
                break
            depth += 1
        for key in keys:
            if key in self._seen:
                self._seen.move_to_end(key)
            else:
                self._seen[key] = True
        while len(self._seen) > self.seen_cap:
            self._seen.popitem(last=False)
        return depth

    def acquire(self, nodes: Sequence[PrefixNode]) -> None:
        """Pin a hit path for one more in-flight request."""
        for node in nodes:
            node.refcount += 1

    def release(self, nodes: Sequence[PrefixNode]) -> None:
        """Unpin a path (request finished / was requeued).  Refcount-0 nodes
        stay cached; they merely become evictable."""
        tick = next(self._tick)
        for node in nodes:
            assert node.refcount > 0, f"release of unpinned {node!r}"
            node.refcount -= 1
            node.last_used = tick

    # -- insert ---------------------------------------------------------
    def insert(self, namespace: Hashable, tokens: Sequence[int],
               page_ids: Sequence[int], *, start_page: int,
               ) -> List[PrefixNode]:
        """Index freshly-prefilled pages: ``page_ids[i]`` backs logical page
        ``start_page + i`` of ``tokens``.  The path ``[0, start_page)`` must
        already be cached (inserts extend an existing path — the batcher
        guarantees this by inserting exactly its miss tail).  Skips keys
        already present (races within one scheduling round are resolved by
        whoever inserted first); returns only the nodes actually created,
        whose pages the caller must re-own (``PagedKVPool.share``)."""
        keys = self._page_keys(tokens)
        assert start_page + len(page_ids) <= len(keys), \
            "page_ids run past the prompt's full pages"
        level = self._roots.setdefault(namespace, {})
        parent: Optional[PrefixNode] = None
        for key in keys[:start_page]:
            parent = level.get(key)
            assert parent is not None, \
                "insert requires the leading path to be cached"
            level = parent.children
        created: List[PrefixNode] = []
        tick = next(self._tick)
        for i, pid in enumerate(page_ids):
            key = keys[start_page + i]
            node = level.get(key)
            if node is None:
                node = PrefixNode(key=key, page_id=int(pid),
                                  namespace=namespace, parent=parent,
                                  last_used=tick)
                level[key] = node
                created.append(node)
                self.n_pages += 1
                self.stats.inserts += 1
            parent = node
            level = node.children
        return created

    # -- evict ----------------------------------------------------------
    def _leaves(self) -> List[PrefixNode]:
        out = []
        stack = [n for roots in self._roots.values() for n in roots.values()]
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node.refcount == 0:
                out.append(node)
        return out

    def evictable_pages(self) -> int:
        """Upper bound on pages reclaimable *right now* (refcount-0 leaves;
        evicting them may expose more — the true total is every page on a
        fully-unpinned subtree, which :meth:`evict` reaches iteratively)."""
        return len(self._leaves())

    def evict(self, n_pages: int) -> List[int]:
        """Reclaim up to ``n_pages`` pages, LRU-first over unpinned leaves
        (re-collecting after each round, so an emptied interior node becomes
        eligible).  Returns the physical ids now free — the caller must
        ``drop_shared`` them from the ledger and push them back onto the
        device free stack."""
        freed: List[int] = []
        while len(freed) < n_pages:
            leaves = sorted(self._leaves(), key=lambda n: n.last_used)
            if not leaves:
                break
            for node in leaves[: n_pages - len(freed)]:
                if node.parent is None:
                    del self._roots[node.namespace][node.key]
                else:
                    del node.parent.children[node.key]
                self.n_pages -= 1
                self.stats.evictions += 1
                freed.append(node.page_id)
        return freed

    def check(self) -> None:
        """Structural invariants (tests): node count matches ``n_pages``,
        refcounts non-negative, every child's parent link is consistent."""
        count = 0
        for roots in self._roots.values():
            stack = [(None, n) for n in roots.values()]
            while stack:
                parent, node = stack.pop()
                assert node.parent is parent, f"parent drift at {node!r}"
                assert node.refcount >= 0, f"negative refcount {node!r}"
                count += 1
                stack.extend((node, c) for c in node.children.values())
        assert count == self.n_pages, (count, self.n_pages)

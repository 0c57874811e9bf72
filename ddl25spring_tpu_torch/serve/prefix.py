"""Host-side radix tree over prompt token prefixes, at page granularity: the
JAX package's ``serve/prefix.py``, line for line.

The device half of prefix caching is pure reference counting
(:mod:`ddl25spring_tpu_torch.serve.kv_pages`); this module is the host half —
the index that maps an incoming prompt to the longest run of
already-resident KV pages:

- **Nodes are pages.**  A *full* node caches one whole page of prompt
  tokens (``page_len`` ids) and may have children; a *partial* node
  caches a prompt's trailing ``< page_len`` tokens and is always a
  leaf.  The physical page id rides on the node — matching a path IS
  discovering which pool rows already hold the prefix KV.
- **Match** walks full children exactly (dict lookup on the token
  tuple), then tries the longest partial leaf, and always leaves at
  least ONE suffix token unmatched (the engine must run the model once
  to sample the request's first token; capping here also keeps the
  ``start <= len - 1`` prefill contract).  Full matched pages are
  shared by reference; a matched partial page is returned as
  ``cow_src`` — the engine copy-on-write duplicates it before the new
  sequence appends into its tail (``kv_pages.adopt_prefix``).
- **Insert** runs after a request's prefill, claiming the prompt's
  pages straight out of the slot's page table.  Content that is
  already cached (same token chunk at the same tree position) is NOT
  re-claimed — the request's own duplicate page stays exclusively its
  sequence's and returns to the pool at completion.
- **Eviction is LRU by last touch, leaves first.**  Only unpinned
  leaves go (pinned = referenced by a live sequence, supplied by the
  engine per call); evicting a node is one cache de-reference on the
  device — the page frees only at refcount 0, so an evicted prefix can
  only ever MISS, never corrupt a live sequence.

Everything here is plain Python over ints — no torch, no device; the
engine owns when device programs run.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Iterator, Sequence

__all__ = ["Match", "PrefixCache"]


@dataclass
class Match:
    """One lookup result: ``pages`` are full pages to share by
    reference (table entries ``0..len(pages)``), ``cow_src`` the
    partially-filled page to copy-on-write (or ``-1``), ``matched`` the
    total prefix tokens covered (page-granular: full pages plus the
    partial page's valid tail)."""

    pages: list[int] = field(default_factory=list)
    cow_src: int = -1
    matched: int = 0

    @property
    def n_ref(self) -> int:
        return len(self.pages)


class _Node:
    __slots__ = ("key", "page", "n_tokens", "children", "parent",
                 "last_touch")

    def __init__(self, key: tuple, page: int, n_tokens: int,
                 parent: "_Node | None", last_touch: int):
        self.key = key
        self.page = page
        self.n_tokens = n_tokens
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.last_touch = last_touch


class PrefixCache:
    """The radix index.  One instance per engine; ``held_pages`` is the
    number of pool pages the cache currently references (exactly one
    per node), which the engine bills against its admission budget."""

    def __init__(self, page_len: int):
        if page_len < 1:
            raise ValueError(f"page_len={page_len} must be >= 1")
        self.page_len = page_len
        self._root = _Node((), -1, 0, None, 0)
        self._clock = 0
        self.held_pages = 0
        # telemetry the engine folds into metrics()
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0

    # ---- lookup --------------------------------------------------------

    def match(self, prompt: Sequence[int]) -> Match:
        """Longest cached prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens so at least one suffix token always
        runs through the model.  Touches every node on the matched path
        (the LRU clock).  Does NOT count lookup/hit stats — the engine
        counts once per ADMITTED request (a queue head may be matched
        several times before admission)."""
        self._clock += 1
        prompt = tuple(int(t) for t in prompt)
        n = len(prompt)
        out = Match()
        node = self._root
        pos = 0
        path: list[_Node] = []
        while True:
            # a full child must fit wholly AND leave >= 1 suffix token
            if pos + self.page_len <= n - 1:
                child = node.children.get(prompt[pos:pos + self.page_len])
                if child is not None and child.n_tokens == self.page_len:
                    path.append(child)
                    out.pages.append(child.page)
                    pos += self.page_len
                    node = child
                    continue
            # no full step: take the longest partial leaf, then stop
            best = None
            for child in node.children.values():
                t = child.n_tokens
                if (t < self.page_len and pos + t <= n - 1
                        and prompt[pos:pos + t] == child.key
                        and (best is None or t > best.n_tokens)):
                    best = child
            if best is not None:
                path.append(best)
                out.cow_src = best.page
                pos += best.n_tokens
            break
        out.matched = pos
        for nd in path:
            nd.last_touch = self._clock
        return out

    # ---- insert --------------------------------------------------------

    def insert(self, prompt: Sequence[int],
               page_row: Sequence[int]) -> list[int]:
        """Index ``prompt``'s pages (``page_row`` = the slot's page
        table after prefill).  Returns the page ids NEWLY claimed by
        the cache — the engine must take one device reference on each
        (``kv_pages.ref_pages``).  Chunks whose content is already
        cached at their tree position claim nothing."""
        self._clock += 1
        prompt = tuple(int(t) for t in prompt)
        n = len(prompt)
        new_pages: list[int] = []
        node = self._root
        pos = 0
        entry = 0
        while pos < n:
            t = min(self.page_len, n - pos)
            page = int(page_row[entry])
            if page < 0:
                break  # table row not populated this far: stop cleanly
            key = prompt[pos:pos + t]
            child = node.children.get(key)
            if child is None:
                child = _Node(key, page, t, node, self._clock)
                node.children[key] = child
                new_pages.append(page)
                self.held_pages += 1
            child.last_touch = self._clock
            if t < self.page_len:
                break  # partial tail: leaf, never descended
            node = child
            pos += t
            entry += 1
        return new_pages

    # ---- eviction ------------------------------------------------------

    def _iter_nodes(self) -> Iterator[_Node]:
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    def evictable_pages(self, pinned: frozenset[int] | set[int]) -> int:
        """How many pages eviction could free right now: nodes whose
        whole subtree is unpinned (children must go before parents)."""

        def walk(nd: _Node) -> tuple[int, bool]:
            cnt, fully = 0, True
            for ch in nd.children.values():
                c, f = walk(ch)
                cnt += c
                fully &= f
            if nd is self._root:
                return cnt, False
            if fully and nd.page not in pinned:
                return cnt + 1, True
            return cnt, False

        return walk(self._root)[0]

    def evict(self, want: int, pinned: frozenset[int] | set[int],
              ) -> list[int]:
        """Remove up to ``want`` unpinned LRU leaves, re-admitting a
        parent the moment its last child goes (so a whole cold chain
        drains in one call).  One tree walk + a heap — this runs on the
        admission hot path, so the per-eviction cost must not be
        another full scan.  Returns the evicted page ids for the
        engine's device unref."""
        out: list[int] = []
        heap: list[tuple[int, int, _Node]] = []
        tie = 0  # heap tiebreak: nodes touched by one call share a clock
        for nd in self._iter_nodes():
            if not nd.children and nd.page not in pinned:
                heapq.heappush(heap, (nd.last_touch, tie, nd))
                tie += 1
        while heap and len(out) < want:
            _, _, nd = heapq.heappop(heap)
            del nd.parent.children[nd.key]
            out.append(nd.page)
            self.held_pages -= 1
            self.evictions += 1
            parent = nd.parent
            if (parent is not self._root and not parent.children
                    and parent.page not in pinned):
                heapq.heappush(heap, (parent.last_touch, tie, parent))
                tie += 1
        return out

    # ---- introspection -------------------------------------------------

    def pages(self) -> list[int]:
        """Every page the cache currently references (exactly one per
        node) — what the invariant sweep reconciles against the device
        refcounts, and the teardown unref path walks."""
        return [nd.page for nd in self._iter_nodes()]

    def __len__(self) -> int:
        return self.held_pages

    def stats(self) -> dict:
        return {
            "enabled": True,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": (
                round(self.hits / self.lookups, 4) if self.lookups else None
            ),
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
            "cached_pages": self.held_pages,
        }

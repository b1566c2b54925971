"""Radix prefix KV cache: block-level cross-request KV reuse (port of
``ray_tpu/models/prefix_cache.py``).

Shared-system-prompt traffic agrees for hundreds of tokens and diverges
at the tail, where an exact-match full-prompt cache never hits. This is a
radix tree over token-id sequences whose nodes own **ref-counted pool
blocks** of :class:`ray_tpu_torch.models.paged_cache.BlockAllocator`.

- **Block granularity, zero-copy sharing.** One tree node = one pool
  block = ``block_size`` tokens. Inserting a finished prompt increfs the
  slot's existing blocks — no device traffic. A hit aliases the cached
  blocks into the new slot's table (``BlockAllocator.adopt``), so prefill
  skips them; attention gathers them through the table like any other
  rows.
- **Copy-on-write at the divergence block.** When the match runs out
  mid-block, the hit reports a COW candidate: the engine duplicates that
  block on the device (``make_block_copy``) into a private block and
  resumes prefill at the exact divergence offset. The cached original
  stays read-only.
- **Eviction never touches a live slot's block.** LRU eviction walks
  leaves whose only reference is the tree's. A shared interior block is
  unevictable until its whole subtree is gone and every slot released
  it; ``BlockAllocator.check_invariants`` is the oracle.
- **Byte budget.** The tree holds at most ``budget_bytes`` worth of
  blocks; inserts evict LRU-first to make room and are dropped (counted,
  never raised) when every candidate is pinned by a live slot.

Host-side only and single-threaded: the engine loop owns it like it owns
the allocator.

:func:`prefix_hashes` is the router's hash of a routing key
(``ray_tpu/serve/handle.py::_RouterState._prefix_hashes``);
:meth:`RadixPrefixCache.digest` hashes cached paths the same way, so the
two compare.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.models.paged_cache import BlockAllocator

PREFIX_CHUNK = 16
PREFIX_MAX_CHUNKS = 8


def _h64(b: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(),
                          "little")


def _token_bytes(tokens) -> bytes:
    # Python ints: numpy 2's repr of an np.int64 would change every hash
    return repr(tuple(int(t) for t in tokens)).encode()


def prefix_hashes(key, chunk: int = PREFIX_CHUNK,
                  max_chunks: int = PREFIX_MAX_CHUNKS) -> List[int]:
    """Hashes of the cumulative ``chunk``-sized prefixes of a routing key
    (tokens for list/tuple prompts, bytes for str/bytes), longest first:
    blake2b-64 of ``repr(tuple(tokens))``."""
    hashes: List[int] = []
    for n_chunks in range(max_chunks, 0, -1):
        cut = key[:n_chunks * chunk]
        if not len(cut):
            continue
        if isinstance(cut, str):
            b = cut.encode()
        elif isinstance(cut, bytes):
            b = cut
        else:
            b = _token_bytes(cut)
        h = _h64(b)
        if not hashes or hashes[-1] != h:
            hashes.append(h)
    return hashes


@dataclasses.dataclass
class PrefixMatch:
    """Result of a tree walk: ``blocks`` are fully matched shared block
    ids covering ``len(blocks) * block_size`` tokens; ``cow`` is the
    optional divergence block — ``(block_id, rows)``: the block's first
    ``rows`` tokens also match and may be reused by copy-on-write.
    ``matched`` counts every reusable token (full blocks + cow rows)."""

    blocks: List[int]
    matched: int
    cow: Optional[Tuple[int, int]] = None


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_used",
                 "tenant")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"], tenant: Optional[str] = None):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        self.tenant = tenant


class RadixPrefixCache:
    """Radix tree over token-id sequences at block granularity."""

    def __init__(self, allocator: BlockAllocator, *, bytes_per_block: int,
                 budget_bytes: int):
        self._alloc = allocator
        self.block_size = allocator.page.block_size
        self.bytes_per_block = max(1, int(bytes_per_block))
        self.budget_bytes = int(budget_bytes)
        self._root = _Node((), 0, None)
        self._nodes = 0
        self._clock = 0      # monotonic LRU counter (no wall time)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.rejected_inserts = 0
        self.cow_hits = 0
        # per-tenant cached-block attribution, for the engine's
        # cache-insert fair share (decremented on eviction)
        self.tenant_blocks: Dict[Optional[str], int] = {}

    # ------------------------------------------------------------ sizing
    @property
    def cached_blocks(self) -> int:
        return self._nodes

    def cached_bytes(self) -> int:
        return self._nodes * self.bytes_per_block

    def budget_blocks(self) -> int:
        return max(0, self.budget_bytes // self.bytes_per_block)

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    # ------------------------------------------------------------- match
    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens``. The caller decides which
        tokens are eligible (the engine passes ``prompt[:-1]``, so the
        block holding the last prompt token — where decode will write —
        is always recomputed privately)."""
        bs = self.block_size
        toks = list(tokens)
        node = self._root
        blocks: List[int] = []
        i = 0
        while i + bs <= len(toks):
            child = node.children.get(tuple(toks[i:i + bs]))
            if child is None:
                break
            self._touch(child)
            blocks.append(child.block)
            node = child
            i += bs
        # divergence: the longest partial-row agreement with any child
        cow = None
        tail = toks[i:]
        if tail:
            best_rows, best_child = 0, None
            for key, child in node.children.items():
                rows = 0
                for a, b in zip(tail, key):
                    if a != b:
                        break
                    rows += 1
                if rows > best_rows:
                    best_rows, best_child = rows, child
            if best_child is not None:
                self._touch(best_child)
                cow = (best_child.block, best_rows)
        matched = i + (cow[1] if cow else 0)
        if matched:
            self.hits += 1
            self.hit_tokens += matched
            if cow:
                self.cow_hits += 1
        else:
            self.misses += 1
        return PrefixMatch(blocks=blocks, matched=matched, cow=cow)

    # ------------------------------------------------------------ insert
    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               tenant: Optional[str] = None,
               max_new: Optional[int] = None) -> int:
        """Insert the full-block prefix of ``tokens`` whose KV lives in
        ``blocks`` (``blocks[i]`` covers tokens ``[i*bs, (i+1)*bs)``: the
        slot's owned blocks, in table order). Existing nodes are reused
        (KV for identical token history is identical, so either physical
        copy serves). ``max_new`` bounds freshly cached blocks (the
        engine's per-tenant insert fair share). Returns new blocks
        cached."""
        bs = self.block_size
        toks = list(tokens)
        nfull = len(toks) // bs
        node = self._root
        # nodes on the insert path are exempt from eviction while it
        # runs: _make_room must never reclaim the node we stand on
        path = {id(node)}
        inserted = 0
        for i in range(min(nfull, len(blocks))):
            key = tuple(toks[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is not None:
                self._touch(child)
                node = child
                path.add(id(node))
                continue
            if max_new is not None and inserted >= max_new:
                break
            if not self._make_room(1, protect=path):
                self.rejected_inserts += 1
                break
            b = int(blocks[i])
            self._alloc.ref_blocks([b])
            child = _Node(key, b, node, tenant)
            node.children[key] = child
            self._touch(child)
            path.add(id(child))
            self._nodes += 1
            inserted += 1
            self.tenant_blocks[tenant] = \
                self.tenant_blocks.get(tenant, 0) + 1
            node = child
        self.inserted_blocks += inserted
        return inserted

    # ---------------------------------------------------------- eviction
    def _evictable_leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self._alloc.refcount(n.block) == 1:
                # the tree holds the only reference: no slot table
                # aliases this block
                out.append(n)
        return out

    def _evict_one(self, protect=frozenset()) -> bool:
        leaves = [n for n in self._evictable_leaves()
                  if id(n) not in protect]
        if not leaves:
            return False
        victim = min(leaves, key=lambda n: n.last_used)
        victim.parent.children.pop(victim.key, None)
        self._alloc.unref_blocks([victim.block])
        self._nodes -= 1
        self.evicted_blocks += 1
        left = self.tenant_blocks.get(victim.tenant, 1) - 1
        if left > 0:
            self.tenant_blocks[victim.tenant] = left
        else:
            self.tenant_blocks.pop(victim.tenant, None)
        return True

    def _make_room(self, nblocks: int, protect=frozenset()) -> bool:
        while self._nodes + nblocks > self.budget_blocks():
            if not self._evict_one(protect):
                return False
        return True

    def evict_for(self, nblocks: int) -> int:
        """Pool pressure: evict up to ``nblocks`` LRU unreferenced leaves
        so admission or decode growth can proceed without preempting a
        live request. Returns blocks returned to the pool."""
        freed = 0
        while freed < nblocks and self._evict_one():
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every node no slot references. Pinned nodes survive."""
        n = 0
        while self._evict_one():
            n += 1
        return n

    # ------------------------------------------------------------ digest
    def digest(self, chunk: int = PREFIX_CHUNK,
               max_chunks: int = PREFIX_MAX_CHUNKS,
               cap: int = 128) -> List[int]:
        """What this tree holds, for prefix-aware routing: blake2b-64
        hashes of the cumulative ``chunk``-token prefixes of every cached
        path (up to ``max_chunks`` chunks deep, ``cap`` entries), the
        same bytes :func:`prefix_hashes` hashes for a token-list key.
        Copies everywhere: the engine thread mutates the tree while a
        caller walks it, and a partial digest is a fine routing hint."""
        out: set = set()
        stack: List[Tuple[_Node, List[int]]] = [(self._root, [])]
        limit = max_chunks * chunk
        while stack and len(out) < cap:
            node, prefix = stack.pop()
            for child in list(node.children.values()):
                toks = prefix + [int(t) for t in child.key]
                for n_chunks in range(1, max_chunks + 1):
                    cut = n_chunks * chunk
                    if len(prefix) < cut <= len(toks):
                        out.add(_h64(_token_bytes(toks[:cut])))
                if len(toks) < limit:
                    stack.append((child, toks))
        return sorted(out)[:cap]

    # -------------------------------------------------------------- misc
    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "cow_hits": self.cow_hits,
            "cached_blocks": self._nodes,
            "cached_bytes": self.cached_bytes(),
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "rejected_inserts": self.rejected_inserts,
        }

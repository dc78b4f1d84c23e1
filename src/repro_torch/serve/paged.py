"""Host-side page bookkeeping for the paged KV cache.

The device side (models/attention.py: PagedAttnCache / PagedView, the
dispatched paged-attention kernel) only ever sees page POOLS and block
TABLES; which physical page backs which request block is decided here, on
the host, by a free-list allocator.  Pages are identical fixed-size units,
so allocation is O(1) pops with zero fragmentation — the whole point of
paging the cache (vLLM, arXiv:2309.06180) versus reserving max-length dense
rings per slot.

Page id ``num_pages`` (one past the pool) is the TRASH page: never
allocated, it absorbs the masked writes of inactive slots in the batched
decode step.  Unused block-table entries also point at it, keeping every
table entry a valid pool index.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Lease:
    """Pages reserved but not yet committed to a running request.

    Chunked prefill spans many scheduler ticks, and speculative decode
    writes K/V for tokens that may be rejected — in both cases pages leave
    the free list BEFORE the request is guaranteed to keep them.  A lease
    makes that window explicit: ``commit`` transfers ownership to the
    request (pages are later returned via :meth:`BlockAllocator.free`),
    ``rollback`` returns them immediately.  Either way the page is never in
    two places at once, which is what the leak tests assert."""

    blocks: list[int]
    state: str = "reserved"   # reserved | committed | rolled_back


class BlockAllocator:
    """Free-list allocator over ``num_pages`` fixed-size KV pages."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"need >=1 pages of >=1 tokens, got {num_pages}x{page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: recently-freed pages are reused first (their cache
        # lines / HBM pages are hottest)
        self._free = list(range(num_pages))
        self._reserved: list[Lease] = []

    @property
    def trash_page(self) -> int:
        return self.num_pages

    @property
    def free_count(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV entries."""
        return -(-max(n_tokens, 1) // self.page_size)

    def can_alloc(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free)

    def alloc(self, n_blocks: int) -> list[int]:
        if not self.can_alloc(n_blocks):
            raise MemoryError(
                f"paged KV OOM: need {n_blocks} pages, {len(self._free)} free"
            )
        taken = self._free[-n_blocks:]
        del self._free[-n_blocks:]
        return taken

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if not 0 <= b < self.num_pages:
                raise ValueError(f"freeing invalid page id {b}")
            if b in self._free:
                raise ValueError(f"double free of page {b}")
        self._free.extend(blocks)

    # -- lease API: reserve → (commit | rollback) ---------------------------

    def reserve(self, n_blocks: int) -> Lease:
        """Take pages off the free list under a revocable lease (chunked
        prefill in flight, speculative tokens not yet verified)."""
        lease = Lease(blocks=self.alloc(n_blocks))
        self._reserved.append(lease)
        return lease

    def commit(self, lease: Lease) -> list[int]:
        """The request keeps the pages; caller now owns them and must
        eventually :meth:`free` them.  Returns the block list."""
        if lease.state != "reserved":
            raise ValueError(f"commit of {lease.state} lease")
        lease.state = "committed"
        self._reserved.remove(lease)
        return lease.blocks

    def rollback(self, lease: Lease) -> None:
        """Abandon the lease (cancelled admission / rejected speculation):
        pages go straight back to the free list."""
        if lease.state != "reserved":
            raise ValueError(f"rollback of {lease.state} lease")
        lease.state = "rolled_back"
        self._reserved.remove(lease)
        self.free(lease.blocks)

    @property
    def reserved_count(self) -> int:
        return sum(len(l.blocks) for l in self._reserved)

    def check_leaks(self, owned: int = 0) -> None:
        """Invariant: free + reserved + caller-owned pages == pool size, and
        the trash page was never handed out."""
        total = self.free_count + self.reserved_count + owned
        if total != self.num_pages:
            raise AssertionError(
                f"page leak: free={self.free_count} reserved={self.reserved_count} "
                f"owned={owned} != pool={self.num_pages}"
            )
        for lease in self._reserved:
            if self.trash_page in lease.blocks:
                raise AssertionError("trash page leaked into a lease")
        if self.trash_page in self._free:
            raise AssertionError("trash page leaked into the free list")

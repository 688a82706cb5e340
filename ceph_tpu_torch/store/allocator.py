"""Free-space allocators for the extent store.

Role of src/os/bluestore/Allocator.h + AvlAllocator.cc /
BitmapAllocator.cc: hand out aligned disk extents, take back released
ones, and survive being rebuilt from the store's metadata at mount
(the modern reference rebuilds the allocation map from onodes rather
than persisting a freelist; ExtentStore does the same, so allocators
here are purely in-RAM).

* ExtentAllocator — interval-set allocator: free space as merged
  (offset, length) runs in sorted order, first-fit allocation with a
  rotating hint to spread wear/fragmentation (AvlAllocator's behavior;
  the balanced tree is a Python sorted list + bisect — same O(log n)
  search, and mutation cost is fine at the fleet sizes one OSD holds).
* BitmapAllocator — one bit per alloc unit over a bytearray; dumb,
  dense, O(n) worst-case scan kept as the cross-check engine (its role
  in the reference test suite, store_test.cc's allocator grinds).

Both allocate whole alloc units (the store's block size); callers get
a list of (offset, length) extents summing to the request.
"""

from __future__ import annotations

import bisect


class AllocError(Exception):
    """ENOSPC analog."""


class Allocator:
    def init_add_free(self, offset: int, length: int) -> None:
        raise NotImplementedError

    def init_rm_free(self, offset: int, length: int) -> None:
        raise NotImplementedError

    def allocate(self, want: int) -> list[tuple[int, int]]:
        """Aligned extents totalling exactly ``want`` bytes (may be
        fragmented).  Raises AllocError when free space is short."""
        raise NotImplementedError

    def release(self, extents) -> None:
        for off, ln in extents:
            self.init_add_free(off, ln)

    @property
    def free_bytes(self) -> int:
        raise NotImplementedError


class ExtentAllocator(Allocator):
    """Interval-set first-fit allocator (AvlAllocator role)."""

    def __init__(self, alloc_unit: int = 4096):
        self.alloc_unit = alloc_unit
        self._offs: list[int] = []      # sorted run starts
        self._lens: dict[int, int] = {}  # start -> run length
        self._free = 0
        self._hint = 0                  # next-fit rotation point

    @property
    def free_bytes(self) -> int:
        return self._free

    def init_add_free(self, offset: int, length: int) -> None:
        assert offset % self.alloc_unit == 0
        assert length % self.alloc_unit == 0
        if length == 0:
            return
        i = bisect.bisect_left(self._offs, offset)
        # coalesce with predecessor / successor runs
        if i > 0:
            p = self._offs[i - 1]
            if p + self._lens[p] > offset:
                raise AllocError("double free at %d" % offset)
            if p + self._lens[p] == offset:
                offset = p
                length += self._lens[p]
                i -= 1
                del self._lens[p]
                del self._offs[i]
        if i < len(self._offs):
            n = self._offs[i]
            if offset + length > n:
                raise AllocError("double free at %d" % offset)
            if offset + length == n:
                length += self._lens[n]
                del self._lens[n]
                del self._offs[i]
        self._offs.insert(i, offset)
        self._lens[offset] = length
        self._free += length

    def init_rm_free(self, offset: int, length: int) -> None:
        """Carve [offset, offset+length) out of the free set (mount
        replay marking blocks an onode references)."""
        if length == 0:
            return
        i = bisect.bisect_right(self._offs, offset) - 1
        if i < 0:
            raise AllocError("rm_free: %d not free" % offset)
        start = self._offs[i]
        ln = self._lens[start]
        if offset + length > start + ln:
            raise AllocError("rm_free: %d+%d not free" % (offset, length))
        del self._offs[i]
        del self._lens[start]
        self._free -= ln
        if start < offset:
            self.init_add_free(start, offset - start)
        if offset + length < start + ln:
            self.init_add_free(offset + length,
                               start + ln - offset - length)

    def allocate(self, want: int) -> list[tuple[int, int]]:
        assert want % self.alloc_unit == 0
        if want > self._free:
            raise AllocError("ENOSPC: want %d free %d"
                             % (want, self._free))
        out: list[tuple[int, int]] = []
        remaining = want
        # next-fit: start at the hint, wrap once
        start_i = bisect.bisect_left(self._offs, self._hint)
        order = list(range(start_i, len(self._offs))) + \
            list(range(0, start_i))
        taken: list[tuple[int, int]] = []
        for i in order:
            off = self._offs[i]
            ln = self._lens[off]
            take = min(ln, remaining)
            taken.append((off, take))
            remaining -= take
            if remaining == 0:
                break
        assert remaining == 0
        for off, take in taken:
            self.init_rm_free(off, take)
            out.append((off, take))
        self._hint = out[-1][0] + out[-1][1]
        return out


class BitmapAllocator(Allocator):
    """One bit per alloc unit; linear next-fit scan."""

    def __init__(self, alloc_unit: int = 4096, size: int = 0):
        self.alloc_unit = alloc_unit
        self._bits = bytearray((size + alloc_unit - 1) // alloc_unit)
        self._free = 0
        self._hint = 0

    @property
    def free_bytes(self) -> int:
        return self._free

    def _grow(self, units: int) -> None:
        if units > len(self._bits):
            self._bits.extend(b"\x00" * (units - len(self._bits)))

    def init_add_free(self, offset: int, length: int) -> None:
        u0 = offset // self.alloc_unit
        n = length // self.alloc_unit
        self._grow(u0 + n)
        for u in range(u0, u0 + n):
            if self._bits[u]:
                raise AllocError("double free at unit %d" % u)
            self._bits[u] = 1
        self._free += n * self.alloc_unit

    def init_rm_free(self, offset: int, length: int) -> None:
        u0 = offset // self.alloc_unit
        n = length // self.alloc_unit
        for u in range(u0, u0 + n):
            if u >= len(self._bits) or not self._bits[u]:
                raise AllocError("rm_free: unit %d not free" % u)
            self._bits[u] = 0
        self._free -= n * self.alloc_unit

    def allocate(self, want: int) -> list[tuple[int, int]]:
        assert want % self.alloc_unit == 0
        n = want // self.alloc_unit
        if want > self._free:
            raise AllocError("ENOSPC: want %d free %d"
                             % (want, self._free))
        out: list[tuple[int, int]] = []
        got = 0
        total = len(self._bits)
        i = self._hint % max(1, total)
        run_start = -1
        scanned = 0
        while got < n and scanned <= total:
            free = i < total and self._bits[i]
            if free:
                if run_start < 0:
                    run_start = i
                got += 1
            if (not free or got == n) and run_start >= 0:
                run_len = (i - run_start) + (1 if free else 0)
                out.append((run_start * self.alloc_unit,
                            run_len * self.alloc_unit))
                run_start = -1
            i += 1
            scanned += 1
            if i >= total:
                i = 0
                if run_start >= 0:      # run cannot wrap the edge
                    out.append((run_start * self.alloc_unit,
                                (total - run_start) * self.alloc_unit))
                    run_start = -1
        assert got == n
        for off, ln in out:
            self.init_rm_free(off, ln)
        self._hint = (out[-1][0] + out[-1][1]) // self.alloc_unit
        return out

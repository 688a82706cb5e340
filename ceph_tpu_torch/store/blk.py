"""Block device layer (L2 substrate).

The analog of the reference's src/blk/ tier (BlockDevice.h:52
create/open/read/write/flush contract, KernelDevice for file-or-raw
targets): stores address a flat byte device in aligned blocks and never
touch the filesystem namespace themselves.

Two engines:

* FileBlockDevice — a (sparse) regular file driven with os.pread /
  os.pwrite + fdatasync.  This is the KernelDevice role; a raw block
  device path works identically since the API is offset-addressed.
* MemBlockDevice — RAM-backed, for tests and ephemeral OSDs.

Devices are dumb by design: no caching, no journaling — crash
semantics (COW + WAL) live in the store above, exactly as BlueStore
owns them above KernelDevice.
"""

from __future__ import annotations

import os
import threading


class BlockDeviceError(Exception):
    pass


class BlockDevice:
    """Flat, offset-addressed byte device (src/blk/BlockDevice.h)."""

    block_size = 4096

    def open(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    def extend(self, new_size: int) -> None:
        """Grow the device (thin-provisioned targets)."""
        raise NotImplementedError

    def read(self, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def write(self, offset: int, data: bytes) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Durability barrier (fdatasync)."""
        raise NotImplementedError


class FileBlockDevice(BlockDevice):
    """KernelDevice analog over a sparse file / raw device path."""

    def __init__(self, path: str, size: int = 1 << 30):
        self.path = path
        self._size = size
        self._fd: int | None = None
        self._lock = threading.Lock()

    def open(self) -> None:
        self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o600)
        st = os.fstat(self._fd)
        if st.st_size < self._size:
            os.ftruncate(self._fd, self._size)   # sparse: no real use
        else:
            self._size = st.st_size

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    @property
    def size(self) -> int:
        return self._size

    def extend(self, new_size: int) -> None:
        if new_size <= self._size:
            return
        assert self._fd is not None, "not open"
        os.ftruncate(self._fd, new_size)
        self._size = new_size

    def read(self, offset: int, length: int) -> bytes:
        assert self._fd is not None, "not open"
        with self._lock:
            data = os.pread(self._fd, length, offset)
        if len(data) < length:
            # reads beyond EOF of a sparse file: zero-fill like a disk
            data += b"\x00" * (length - len(data))
        return data

    def write(self, offset: int, data: bytes) -> None:
        assert self._fd is not None, "not open"
        if offset + len(data) > self._size:
            raise BlockDeviceError(
                "write beyond device (%d+%d > %d)"
                % (offset, len(data), self._size))
        with self._lock:
            os.pwrite(self._fd, data, offset)

    def flush(self) -> None:
        assert self._fd is not None, "not open"
        try:
            os.fdatasync(self._fd)
        except AttributeError:          # platforms without fdatasync
            os.fsync(self._fd)


class MemBlockDevice(BlockDevice):
    """RAM device for tests: same contract, no durability."""

    def __init__(self, size: int = 1 << 26):
        self._size = size
        self._buf = bytearray()

    def open(self) -> None:
        if len(self._buf) < self._size:
            self._buf.extend(b"\x00" * (self._size - len(self._buf)))

    def close(self) -> None:
        pass

    @property
    def size(self) -> int:
        return self._size

    def extend(self, new_size: int) -> None:
        if new_size > self._size:
            self._buf.extend(b"\x00" * (new_size - self._size))
            self._size = new_size

    def read(self, offset: int, length: int) -> bytes:
        return bytes(self._buf[offset:offset + length])

    def write(self, offset: int, data: bytes) -> None:
        if offset + len(data) > self._size:
            raise BlockDeviceError("write beyond device")
        self._buf[offset:offset + len(data)] = data

    def flush(self) -> None:
        pass

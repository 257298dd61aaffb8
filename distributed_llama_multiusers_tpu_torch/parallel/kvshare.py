"""A pod's paged KV pool, readable across its processes: the read of a whole
page when its heads lie in more than one process.

On a pod (parallel/multihost.py) every process holds the pool planes of its
own ranks, each rank's kv heads of every page. A page's payload
(``export_kv_page``, ``swap_out_pages``: K then V, [L, page, n_kv, hd]) holds
every rank's heads, and the pool's bookkeeping runs on the root only, so the
root reads the heads its peers hold. No packet asks a worker for them: each
rank's K and V planes live in memory its peers map, and the root reads a
page's remote head slices straight from there, the way a ring step's
receiver reads its sender's window (parallel/window.py). A rank's region:

    [count words: one u32 (CPU: i64) a rank][K plane][V plane]

- on the card (``CudaPoolShare``) a region is one ``cudaMalloc`` (zeroed),
  exported with ``cudaIpcGetMemHandle`` and opened by every other process of
  the host on its first rank's device; the region is the share's own, not
  the caching allocator's, so a handle's base is the region's base. A read
  is an indexed gather of the mapped planes on the reader's stream, an
  e4m3 plane read as its bytes. The count words are written and waited on
  by stream memory operations (``csrc/ring_hop.cu``);
- on the CPU (``FilePoolShare``) a region is one shared-memory file that
  every process maps, and a wait spins, checking that the peer lives.

The handles (or file paths) and each owner's process id cross the pod's
bootstrap store.

Ordering. Every process makes the same page writes in the same order (an
import, a swap-in batch, a copy-on-write copy: each the replay of one
packet), and after each it writes its count of them into the first count
word of every peer process, its own word there, behind the write on its
stream. A read first waits, on the reader's stream, until each peer's word
in the reader's region has reached the reader's own count: the peer has
made every page write the reader made. A step's KV writes need no count:
a worker writes them before that step's ring steps, whose pulls the
root's same step waited for (the windows' epoch waits), and the read runs
on the root's stream after every step it dispatched. A page is read only
when its bytes are final, a committed block (an export, which no step
writes again) or a page no lane maps (a swap-out), and a worker writes it
again only when it replays a packet the root sends after the read's host
copy has returned. A peer that died before the read returns makes the
read raise ``PodPeerLost``, never a partial page.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import time

import numpy as np
import torch

from .window import ALIGN, MASK32, PodPeerLost, _check, alive

CTRL_BYTES = 256  # a region's count words, one a rank
_LIVENESS_S = 0.5  # the CPU spin: how often it checks that the peer lives


def _nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def region_bytes(shape, dtype: torch.dtype) -> int:
    """One rank's count words and its K and V planes of ``shape``."""
    return CTRL_BYTES + _aligned(_nbytes(shape, dtype)) + _nbytes(shape, dtype)


def _planes(raw: torch.Tensor, shape, dtype: torch.dtype) -> tuple:
    """K and V planes of ``shape`` over a region's bytes."""
    n = _nbytes(shape, dtype)
    return tuple(raw[start:start + n].view(dtype).view(shape)
                 for start in (CTRL_BYTES, CTRL_BYTES + _aligned(n)))


class _PoolShare:
    """What both backends share. ``planes[r]`` is rank r's (K, V): the
    rank's own pool planes where this process holds it, else the peer's
    mapped; ``owner[r]`` the process id that holds a peer's rank r. Each
    process is known by its first rank: its count word's index, and the
    region whose words it reads."""

    def __init__(self, n: int, local: dict):
        if n * 8 > CTRL_BYTES:
            raise ValueError(f"a pod's KV pool share holds at most {CTRL_BYTES // 8} ranks")
        self.n = n
        self.local = dict(local)
        self.first = min(self.local)
        per = len(self.local)
        self.peers = [r for r in range(0, n, per) if r != self.first]
        self.planes: dict = {}
        self.owner: dict = {}

    def check_peers(self) -> None:
        """Raise ``PodPeerLost`` when a process whose planes this one maps
        has died: what was read from them is not trusted."""
        for r, pid in self.owner.items():
            if not alive(pid):
                raise PodPeerLost(f"rank {r}'s process ({pid}) died: its KV pool planes "
                                  "cannot be read")


class CudaPoolShare(_PoolShare):
    """Pool regions in device memory of the share's own, through CUDA IPC."""

    def __init__(self, n: int, local: dict, shape, dtype: torch.dtype, store, prefix: str):
        super().__init__(n, local)
        from ..ops import ring_collective as rc
        from ..ops.cuda_q40 import load_kernel

        v = ctypes.c_void_p
        alloc = load_kernel(rc.KERNEL, [ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(v),
                                        ctypes.c_char_p], "ring_window_alloc")
        opener = load_kernel(rc.KERNEL, [ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(v)],
                             "ring_window_open")
        self._wait_fn = load_kernel(rc.KERNEL, [v, v, ctypes.c_uint], "ring_wait_value_geq")
        self._write_fn = load_kernel(rc.KERNEL, [v, v, ctypes.c_uint], "ring_write_value")
        size = region_bytes(shape, dtype)
        self.base: dict = {}  # global rank -> its region's address in this process
        for r, dev in self.local.items():
            ptr, handle = v(), ctypes.create_string_buffer(64)
            _check(alloc(dev.index, size, ctypes.byref(ptr), handle), "KV pool cudaMalloc/IPC")
            self.base[r] = ptr.value
            self.planes[r] = _planes(_device_bytes(ptr.value, size, dev), shape, dtype)
            store.set(f"{prefix}/cuda/{r}", handle.raw)
            store.set(f"{prefix}/owner/{r}", str(os.getpid()))
        self.device = self.local[self.first]
        for r in range(n):
            if r in self.local:
                continue
            ptr = v()
            _check(opener(self.device.index, store.get(f"{prefix}/cuda/{r}"),
                          ctypes.byref(ptr)), f"cudaIpcOpenMemHandle of rank {r}'s KV pool")
            self.base[r] = ptr.value
            self.planes[r] = _planes(_device_bytes(ptr.value, size, self.device), shape, dtype)
            self.owner[r] = int(store.get(f"{prefix}/owner/{r}"))

    def _stream(self):
        """The first rank's stream, behind every other local device's
        current work (a pod's process may hold ranks on several cards)."""
        stream = torch.cuda.current_stream(self.device)
        for dev in set(self.local.values()) - {self.device}:
            stream.wait_event(torch.cuda.current_stream(dev).record_event())
        return stream

    def post(self, count: int) -> None:
        """After this process's page writes: ``count`` into its word of
        every peer's region, behind them on the stream."""
        stream = self._stream()
        for p in self.peers:
            _check(self._write_fn(stream.cuda_stream, self.base[p] + 4 * self.first,
                                  count & MASK32), "cuStreamWriteValue32 (KV pool count)")

    def wait(self, count: int) -> None:
        """The reader's stream waits until every peer's count in this
        process's region has reached ``count``."""
        stream = torch.cuda.current_stream(self.device)
        for p in self.peers:
            _check(self._wait_fn(stream.cuda_stream, self.base[self.first] + 4 * p,
                                 count & MASK32), "cuStreamWaitValue32 (KV pool count)")


class _DeviceBytes:
    """A device allocation as ``__cuda_array_interface__`` (bytes): what
    ``torch.as_tensor`` wraps without a copy, holding this object."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 2, "strides": None}


def _device_bytes(ptr: int, nbytes: int, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(_DeviceBytes(ptr, nbytes), device=dev)
    if t.data_ptr() != ptr or t.device != dev:
        raise RuntimeError(f"the KV pool region at {ptr:#x} wrapped as {t.device} "
                           f"{t.data_ptr():#x}, not {dev}")
    return t


class FilePoolShare(_PoolShare):
    """Pool regions in one shared-memory file a rank (the CPU's)."""

    def __init__(self, n: int, local: dict, shape, dtype: torch.dtype, store, prefix: str):
        super().__init__(n, local)
        size = region_bytes(shape, dtype)
        self.raw: dict = {}
        paths = []
        for r in self.local:
            fd, path = tempfile.mkstemp(prefix=f"dllama_pod_kv_rank{r}_")
            with os.fdopen(fd, "wb") as f:
                f.truncate(size)  # zero-filled
            paths.append(path)
            self.raw[r] = _map(path, size)
            store.set(f"{prefix}/file/{r}", f"{os.getpid()} {path}")
        for r in range(n):
            if r not in self.local:
                pid, path = store.get(f"{prefix}/file/{r}").decode().split(" ", 1)
                self.owner[r] = int(pid)
                self.raw[r] = _map(path, size)
        for r, raw in self.raw.items():
            self.planes[r] = _planes(raw, shape, dtype)
        # every process has mapped every rank's file: the files can go
        store.add(f"{prefix}/mapped", len(self.local))
        while int(store.add(f"{prefix}/mapped", 0)) < n:
            time.sleep(0.01)
        for path in paths:
            os.unlink(path)

    def _words(self, r: int) -> torch.Tensor:
        return self.raw[r][:CTRL_BYTES].view(torch.int64)

    def post(self, count: int) -> None:
        for p in self.peers:
            self._words(p)[self.first] = count

    def wait(self, count: int) -> None:
        """Spin until every peer's count in this process's region has
        reached ``count``, checking that the peer lives."""
        words = self._words(self.first)
        check_at = time.perf_counter() + _LIVENESS_S
        for p in self.peers:
            spins = 0
            while int(words[p]) < count:
                spins += 1
                if spins > 64:
                    time.sleep(0.0001)
                if time.perf_counter() >= check_at:
                    check_at = time.perf_counter() + _LIVENESS_S
                    self.check_peers()


def _map(path: str, size: int) -> torch.Tensor:
    storage = torch.UntypedStorage.from_file(path, shared=True, nbytes=size)
    return torch.tensor([], dtype=torch.uint8).set_(storage)


def open_pool_share(n: int, local: dict, shape, dtype: torch.dtype, store,
                    prefix: str = "pod/kvpool"):
    """The pod's KV pool planes: one region of its K and V planes ``shape``
    (one rank's heads) for each of this process's ranks (``local``: global
    rank -> device), every other rank's mapped; collective over the pod
    (every process calls it with the same ``n``, ``shape``, ``dtype`` and
    ``prefix``)."""
    kinds = {d.type for d in local.values()}
    if kinds == {"cuda"}:
        return CudaPoolShare(n, local, shape, dtype, store, prefix)
    if kinds == {"cpu"}:
        return FilePoolShare(n, local, shape, dtype, store, prefix)
    raise ValueError(f"a pod's local ranks lie on one device type, not {sorted(kinds)}")

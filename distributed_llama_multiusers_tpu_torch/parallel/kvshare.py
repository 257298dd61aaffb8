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
  every process maps, and a wait spins, checking that the peer lives;
- over sockets (``SocketPoolShare``, pods across hosts) no process maps a
  peer's planes: each process serves its peers' reads of its heads on a
  server thread, one TCP connection from each reader. A request is the
  pages and the count of page writes the reader has made; the server waits
  until its own count has reached it, gathers its ranks' heads on a side
  stream behind its last counted write, and sends them.

The handles (or file paths, or listening addresses) and each owner's
process id cross the pod's bootstrap store. ``read`` is the one read of
every rank's heads of some pages, whatever the transport: the bytes are
the same.

Ordering. Every process makes the same page writes in the same order (an
import, a swap-in batch, a copy-on-write copy: each the replay of one
packet), and after each it writes its count of them into the first count
word of every peer process, its own word there, behind the write on its
stream. A read first waits, on the reader's stream, until each peer's word
in the reader's region has reached the reader's own count: the peer has
made every page write the reader made. A step's KV writes need no count:
a worker writes them before that step's ring steps, whose pulls the
root's same step waited for (the windows' epoch waits). Through a mapping
the read runs on the root's stream after every step it dispatched. Over
sockets a peer gathers on a side stream that waits only for its last
counted write, so the reader first synchronises its own streams: every
step it dispatched has then pulled the peers' frames, each sent after the
peer's stream had made that step's KV writes. A page is read only
when its bytes are final, a committed block (an export, which no step
writes again) or a page no lane maps (a swap-out), and a worker writes it
again only when it replays a packet the root sends after the read's host
copy has returned. A peer that died before the read returns makes the
read raise ``PodPeerLost``, never a partial page.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import struct
import tempfile
import threading
import time

import numpy as np
import torch

from ..models.llama import cache_bits
from .window import (ALIGN, MASK32, POLL_S, PodPeerLost, _accept, _check, _connect, _listen,
                     _recv_exact, _recv_frame_start, _send_all, _spin, alive)

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

    def close(self) -> None:
        """Nothing to release: the regions go with the process."""

    def read(self, idx: torch.Tensor, count: int) -> list:
        """Every rank's heads of pages ``idx`` once every peer has made
        ``count`` page writes: (K, V) a rank in rank order, each [L, pages,
        page, heads, hd] (an e4m3 plane as its bytes), gathered on the
        reader's stream from the mapped planes."""
        self.wait(count)
        return [tuple(cache_bits(p).index_select(1, idx.to(p.device)) for p in self.planes[r])
                for r in range(self.n)]


class CudaPoolShare(_PoolShare):
    """Pool regions in device memory of the share's own, through CUDA IPC."""

    transport = "cuda-ipc"

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

    transport = "shared-memory files"

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
        check_at = [time.perf_counter() + _LIVENESS_S]

        def check() -> None:
            if time.perf_counter() >= check_at[0]:
                check_at[0] = time.perf_counter() + _LIVENESS_S
                self.check_peers()

        for p in self.peers:
            _spin(lambda: int(words[p]) >= count, check)


# a read request: magic, the reader's count of page writes (mod 2**32), the
# number of pages (their int64 ids follow); the answer: magic, payload bytes
REQUEST = struct.Struct("<IIQ")
ANSWER = struct.Struct("<IQ")
READ_MAGIC = 0x444C4B56  # "DLKV"
BYE_PAGES = (1 << 64) - 1  # a request's page count when the reader closes on purpose


class SocketPoolShare(_PoolShare):
    """A pod's pool planes read over TCP (pods across hosts): ``planes``
    holds this process's ranks only, and ``read`` asks each peer process's
    server thread for its heads. ``address``: (listen, publish), as
    ``SocketWindows`` takes it. ``on_lost(detail)`` runs on a server
    thread when a peer's connection ends or tears (None: ``check_peers``
    raises it)."""

    transport = "socket"

    def __init__(self, n: int, local: dict, shape, dtype: torch.dtype, store, prefix: str,
                 address: tuple = ("127.0.0.1", "127.0.0.1"), on_lost=None):
        super().__init__(n, local)
        self.device = self.local[self.first]
        self.cuda = self.device.type == "cuda"
        self.shape, self.dtype = tuple(shape), dtype
        for r, dev in self.local.items():
            self.planes[r] = tuple(torch.zeros(shape, dtype=dtype, device=dev) for _ in range(2))
        self.on_lost = on_lost
        self.lost: PodPeerLost | None = None
        self.closing = threading.Event()
        self._count = 0  # page writes this process has made
        self._events: dict = {}  # device -> an event behind the last counted write
        self._counted = threading.Condition()
        self._read_lock = threading.Lock()
        self._side = ({dev: torch.cuda.Stream(dev) for dev in set(self.local.values())}
                      if self.cuda else {})
        listen, publish = address
        listener = _listen(listen, len(self.peers))
        try:
            port = listener.getsockname()[1]
            store.set(f"{prefix}/sock/{self.first}", f"{publish}:{port}")
            hello = REQUEST.pack(READ_MAGIC, self.first, 0)
            self._clients = {p: _connect(store.get(f"{prefix}/sock/{p}").decode(), hello)
                             for p in self.peers}
            self._served = []
            for _ in self.peers:
                sock, got = _accept(listener, REQUEST.size)
                self._served.append(sock)
                if REQUEST.unpack(got)[0] != READ_MAGIC:
                    raise PodPeerLost("a connection to the pod's KV pool share sent no "
                                      "share hello")
        finally:
            listener.close()
        for sock in self._served:
            threading.Thread(target=self._serve, args=(sock,), daemon=True,
                             name="pod-kvpool-serve").start()

    def post(self, count: int) -> None:
        """After this process's page writes: its count, and (on the card)
        an event behind them on each local device's stream, which the
        server thread's gathers wait for."""
        events = ({dev: torch.cuda.current_stream(dev).record_event() for dev in self._side}
                  if self.cuda else {})
        with self._counted:
            self._count = count
            self._events = events
            self._counted.notify_all()

    def wait(self, count: int) -> None:
        """Nothing to wait for here: a read's request carries ``count``
        and each peer's server waits for it."""

    def check_peers(self) -> None:
        if self.lost is not None:
            raise self.lost

    def read(self, idx: torch.Tensor, count: int) -> list:
        """Every rank's heads of pages ``idx`` (``_PoolShare.read``): this
        process's gathered on its stream, each peer's asked of its server
        with ``count`` (the answer comes once the peer has made that many
        page writes), as host tensors. The requests go out only once this
        process's streams have run every step it dispatched (the module
        docstring's Ordering). A peer that is gone, or an answer that is not
        the one asked for, raises ``PodPeerLost``."""
        self.check_peers()
        for dev in self._side:
            torch.cuda.current_stream(dev).synchronize()
        pages = np.ascontiguousarray(idx.cpu().numpy(), np.int64)
        per = len(self.local)
        size = _nbytes((self.shape[0], len(pages), *self.shape[2:]), self.dtype)
        bits = cache_bits(torch.empty(0, dtype=self.dtype)).dtype
        shape = (self.shape[0], len(pages), *self.shape[2:])
        with self._read_lock:
            for p in self.peers:
                _send_all(self._clients[p], REQUEST.pack(READ_MAGIC, count & MASK32, len(pages)))
                _send_all(self._clients[p], pages)
            heads = {r: tuple(cache_bits(p).index_select(1, idx.to(p.device))
                              for p in self.planes[r]) for r in self.local}
            for p in self.peers:
                head = bytearray(ANSWER.size)
                if not _recv_frame_start(self._clients[p], head, self.closing):
                    raise PodPeerLost("the pod's KV pool share closed during a read")
                got = ANSWER.unpack(head)
                if got != (READ_MAGIC, 2 * per * size):
                    raise PodPeerLost(f"rank {p}'s process answered a page read with {got} "
                                      f"(magic, bytes), expected {(READ_MAGIC, 2 * per * size)}")
                raw = torch.empty(2 * per * size, dtype=torch.uint8)
                _recv_exact(self._clients[p], raw.numpy())
                for i in range(per):
                    heads[p + i] = tuple(raw[(2 * i + j) * size:(2 * i + j + 1) * size]
                                         .view(bits).view(shape) for j in (0, 1))
        return [heads[r] for r in range(self.n)]

    def _serve(self, sock) -> None:
        """A peer's reads of this process's heads, one at a time, until the
        share closes; a peer whose connection ends or tears is lost."""
        try:
            while True:
                head = bytearray(REQUEST.size)
                if not _recv_frame_start(sock, head, self.closing):
                    return
                magic, count, n_pages = REQUEST.unpack(head)
                if magic == READ_MAGIC and n_pages == BYE_PAGES:
                    return
                if magic != READ_MAGIC:
                    raise PodPeerLost(f"a KV pool page read's header starts {magic:#x}: a torn "
                                      "request")
                pages = np.empty(n_pages, np.int64)
                _recv_exact(sock, pages)
                raw = self._answer(torch.from_numpy(pages), count)
                _send_all(sock, ANSWER.pack(READ_MAGIC, raw.numel()))
                _send_all(sock, raw.numpy())
        except (PodPeerLost, OSError) as e:
            if self.closing.is_set():
                return
            lost = e if isinstance(e, PodPeerLost) else PodPeerLost(
                f"a pod KV pool share connection failed: {type(e).__name__}: {e}")
            if self.on_lost is not None:
                self.on_lost(str(lost))
            if self.lost is None:
                self.lost = lost

    def _answer(self, idx: torch.Tensor, count: int) -> torch.Tensor:
        """This process's heads of pages ``idx`` as host bytes (K then V a
        rank, in rank order), once its count of page writes has reached
        ``count`` (cyclically, as the card's count words compare): on the
        card gathered on a side stream behind the last counted write."""
        with self._counted:
            while (self._count - count) & MASK32 >= 1 << 31:
                self._counted.wait(POLL_S)
                if self.closing.is_set():
                    raise PodPeerLost("the pod's KV pool share closed during a read")
            events = dict(self._events)
        parts = []
        for r, dev in self.local.items():
            side = self._side.get(dev)
            with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
                if dev in events:
                    side.wait_event(events[dev])
                for p in self.planes[r]:
                    parts.append(cache_bits(p).index_select(1, idx.to(dev)).contiguous()
                                 .view(torch.uint8).reshape(-1).cpu())
        return torch.cat(parts)

    def close(self) -> None:
        """Say goodbye to every peer's server (its thread ends without a
        loss), then close the connections."""
        self.closing.set()
        for sock in self._clients.values():
            try:
                _send_all(sock, REQUEST.pack(READ_MAGIC, 0, BYE_PAGES))
            except (OSError, PodPeerLost):
                pass
        for sock in list(self._clients.values()) + self._served:
            sock.close()


def _map(path: str, size: int) -> torch.Tensor:
    storage = torch.UntypedStorage.from_file(path, shared=True, nbytes=size)
    return torch.tensor([], dtype=torch.uint8).set_(storage)


def open_pool_share(n: int, local: dict, shape, dtype: torch.dtype, store,
                    prefix: str = "pod/kvpool"):
    """The pod's KV pool planes: one region of its K and V planes ``shape``
    (one rank's heads) for each of this process's ranks (``local``: global
    rank -> device), every other rank's mapped, or read over sockets where
    the pod chose them (``multihost.pod_transport``); collective over the
    pod (every process calls it with the same ``n``, ``shape``, ``dtype``
    and ``prefix``)."""
    from . import multihost

    kinds = {d.type for d in local.values()}
    if kinds - {"cuda", "cpu"} or len(kinds) != 1:
        raise ValueError(f"a pod's local ranks lie on one device type, not {sorted(kinds)}")
    if multihost.pod_transport() == "socket":
        return SocketPoolShare(n, local, shape, dtype, store, prefix,
                               address=multihost.pod_address(), on_lost=multihost.peer_lost)
    if kinds == {"cuda"}:
        return CudaPoolShare(n, local, shape, dtype, store, prefix)
    return FilePoolShare(n, local, shape, dtype, store, prefix)

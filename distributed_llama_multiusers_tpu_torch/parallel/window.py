"""Per-rank windows: the memory a pod process lets its peers read, and the
order of a ring step across processes.

In one process the ring hop's receiver pulls straight from the sender's
tensor and waits on an event of the sender's stream (ops/ring_collective.py).
In a pod (parallel/multihost.py) the sender is another process: neither its
tensor nor its event exists in the receiver. So each rank owns one window,
made once at startup and big enough for the largest step's segments in each
of ``NSLOTS`` slots:

    [ready words: NSLOTS x u32][consumed words: NSLOTS x u32][slot 0][slot 1]

At ring step ``e`` (every process runs the same steps in the same order, so
the epoch counter agrees everywhere) the slot is ``e % NSLOTS``:

- the sender waits until its own ``consumed[slot]`` word reads ``e -
  NSLOTS`` (the receiver is done with the slot's last use), stages the
  step's wire segments into that slot, then writes ``e`` into the
  receiver's ``ready[slot]`` word;
- the receiver waits until its own ``ready[slot]`` word reads ``e``, pulls
  the segments from the sender's slot (adding, or writing the gather slot,
  as a local step does), then writes ``e`` into the sender's
  ``consumed[slot]`` word.

Every wait polls the waiter's own window; every flag write lands in a
peer's. Exact-value waits let the 32-bit words wrap.

On the card (``CudaWindows``) a window is one ``cudaMalloc`` exported with
``cudaIpcGetMemHandle`` and opened by every other process of the host, the
staging copy and the pull are ``csrc/ring_hop.cu`` launches, and the waits
and flag writes are stream memory operations: nothing waits on the host.
On the CPU (``FileWindows``) a window is a shared-memory file a rank, the
copies are the ring step's plain version and the waits spin on the host,
checking that the peer process is still alive. The handles (or file paths)
are swapped through the pod's bootstrap store; no activation crosses it.

Across hosts (``SocketWindows``) no process maps another's memory. Each ring
link (the process holding rank r - 1 to the one holding rank r) is one TCP
connection, and each end owns a buffer of the same layout: the sender
stages into its own slot, a transport thread sends the slot as one frame
(its header: the epoch, the slot, the byte count), the receiver's transport
thread reads it into its own slot, and the receiver pulls from there. The
words keep their meaning, but every one is written and read in the
process that owns it: the sender's ``consumed`` word is written by its
send thread once the slot has gone out, the receiver's ``ready`` word by
its receive thread once the slot has come in, and the receiver's receive
thread waits for its own ``consumed`` word before it reads the next frame
into the slot. On the card (``CudaSocketWindows``) a buffer is pinned host
memory mapped into the device: the staging and the pull stay one ring-step
launch each, and the streams' waits and writes stay stream memory
operations, so no stream waits on the host; on the CPU (``SocketWindows``)
the ring step's plain version stages and pulls, and the waits spin on the
host. A link that ends (EOF, a
reset), stalls inside a frame, or delivers a frame whose header is not the
one expected is a lost peer: ``on_lost`` (a pod's: log it and end the
process, parallel/multihost.py).
"""

from __future__ import annotations

import ctypes
import os
import queue
import select
import socket
import struct
import tempfile
import threading
import time

import numpy as np
import torch

from ..ops import ring_collective as rc

NSLOTS = 2
WORD = 4  # bytes of an epoch word
READY_OFF = 0
CONSUMED_OFF = 128
CTRL_BYTES = 256
ALIGN = 256  # a segment's offset in its slot
MASK32 = 0xFFFFFFFF
# the CPU spin: how often it checks that the peer process lives
_LIVENESS_S = 0.5
# a socket link's frame header: magic, epoch (mod 2**32), slot, payload bytes
FRAME = struct.Struct("<IIIQ")
FRAME_MAGIC = 0x444C5246  # "DLRF"
BYE = 0xFFFFFFFF  # a frame's slot when its end closes the link on purpose
# once a frame's header has begun, the rest arrives within this (a peer that
# stalls inside a frame is lost; between frames a link may idle for days)
FRAME_TIMEOUT_S = 60.0
# how often a transport thread looks up from a wait to see the windows close
POLL_S = 0.1
CONNECT_TIMEOUT_S = 120.0  # every link of the pod connects within this


class PodPeerLost(RuntimeError):
    """A peer process of the pod died while this one waited for it (or,
    over sockets, its link ended, stalled or tore)."""


def align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def window_bytes(slot_bytes: int) -> int:
    return CTRL_BYTES + NSLOTS * align(slot_bytes)


def _wire(segs) -> list:
    """(segment, offset in the slot, bytes) of a step's wire segments, laid
    out one after another in a window slot, sized from the sources (the
    sender's side) or the destinations (the receiver's), whose shapes and
    dtypes are the same."""
    out, off = [], 0
    for seg in segs:
        if seg.wire:
            t = seg.src if seg.src is not None else seg.dst
            nbytes = t.numel() * t.element_size()
            out.append((seg, off, nbytes))
            off = align(off + nbytes)
    return out


def _span(wire: list) -> int:
    """Bytes a step's wire segments take in a slot, padding between them
    included (0 for none)."""
    return wire[-1][1] + wire[-1][2] if wire else 0


class _Windows:
    """What both backends share: the ranks, the epoch and the layout.
    ``local`` maps each of this process's global ranks to its device."""

    def __init__(self, n: int, local: dict, slot_bytes: int):
        self.n = n
        self.local = dict(local)
        self.slot_bytes = align(slot_bytes)
        self.epoch = NSLOTS - 1  # the first step is epoch NSLOTS: slot 0
        self.timing = False
        self.stats = {"steps": 0, "stages": 0, "pulls": 0, "waits": 0, "wait_ms": 0.0}

    def reset_stats(self) -> None:
        """Zero the counters (not the epoch: it is the pod's step count)."""
        self.stats = {k: type(v)() for k, v in self.stats.items()}

    def next_epoch(self) -> tuple[int, int]:
        self.epoch += 1
        self.stats["steps"] += 1
        return self.epoch, self.epoch % NSLOTS

    def slot_offset(self, slot: int, off: int) -> int:
        return CTRL_BYTES + slot * self.slot_bytes + off

    def check_fits(self, nbytes: int) -> None:
        if nbytes > self.slot_bytes:
            raise ValueError(f"a ring step's wire segments ({nbytes} B) exceed the pod "
                             f"window's slot ({self.slot_bytes} B)")

    def step(self, recv: list) -> None:
        """A ring step across the pod's processes (``ring_collective.
        ring_step`` while these windows are installed), in the order above:
        this process's senders whose receiver is remote stage their wire
        segments, then its receivers pull, from the peer's slot where the
        sender is remote and straight from the sender's tensor where it is
        local. ``recv`` spans every global rank: a remote receiver's
        segments have no destination, a remote sender's no source."""
        n = self.n
        if len(recv) != n:
            raise ValueError(f"a pod ring step has {len(recv)} receiving ranks, the pod {n}")
        e, slot = self.next_epoch()
        stage, pull, local = [], [], []
        for r in range(n):
            sender = (r - 1) % n
            if sender in self.local and r not in self.local:
                stage.append((sender, r, _wire(recv[r])))
            elif r in self.local:
                if sender in self.local:
                    local.append(recv[r])
                else:
                    pull.append((sender, r, _wire(recv[r])))
        for _, _, wire in stage + pull:
            if wire:
                self.check_fits(_span(wire))
        self._announce(e, slot, stage, pull)
        for sender, r, wire in stage:
            stream = self._stream(sender)
            self.wait(sender, CONSUMED_OFF, slot, e - NSLOTS, stream)
            self._stage(sender, slot, wire, stream)
            self.stats["stages"] += 1
            self.post(r, READY_OFF, slot, e, stream)
        for sender, r, wire in pull:
            stream = self._stream(r)
            self.wait(r, READY_OFF, slot, e, stream)
            self._pull(sender, r, slot, wire, [s for s in recv[r] if not s.wire], stream)
            self.stats["pulls"] += 1
            self.post(sender, CONSUMED_OFF, slot, e, stream)
        if local:
            rc.local_step(local)

    def _announce(self, e: int, slot: int, stage: list, pull: list) -> None:
        """Before a step's waits: what the step stages and pulls (a
        transport that moves slots on threads of its own queues them)."""

    @staticmethod
    def _first_values() -> list:
        """The words' values before the first step: slot s's last use was
        epoch s, already consumed, and no ready word reads an epoch >=
        NSLOTS."""
        return list(range(NSLOTS))


class _StreamWords:
    """The card's waits and flag writes: stream memory operations on the
    32-bit word at ``self._word(r, kind_off, slot)``, and the ms the
    streams waited, from events around each wait while timed."""

    def _load_stream_ops(self) -> None:
        from ..ops.cuda_q40 import load_kernel

        v = ctypes.c_void_p
        self._wait_fn = load_kernel(rc.KERNEL, [v, v, ctypes.c_uint], "ring_wait_value")
        self._write_fn = load_kernel(rc.KERNEL, [v, v, ctypes.c_uint], "ring_write_value")
        self._timed: list = []

    def wait(self, r: int, kind_off: int, slot: int, value: int, stream) -> None:
        """``stream`` waits until rank r's word reads ``value``."""
        self.stats["waits"] += 1
        if self.timing:
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record(stream)
        _check(self._wait_fn(stream.cuda_stream, self._word(r, kind_off, slot), value & MASK32),
               "cuStreamWaitValue32")
        if self.timing:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record(stream)
            self._timed.append((t0, t1))

    def post(self, r: int, kind_off: int, slot: int, value: int, stream) -> None:
        """``stream`` writes ``value`` into rank r's word, after the work
        before it."""
        _check(self._write_fn(stream.cuda_stream, self._word(r, kind_off, slot), value & MASK32),
               "cuStreamWriteValue32")

    def start_timing(self) -> None:
        self._timed = []
        self.timing = True

    def stop_timing(self) -> float:
        """Milliseconds this process's streams waited since
        ``start_timing`` (events around every wait)."""
        self.timing = False
        for t0, t1 in self._timed:
            t1.synchronize()
        ms = sum(t0.elapsed_time(t1) for t0, t1 in self._timed)
        self.stats["wait_ms"] += ms
        return ms


class CudaWindows(_StreamWords, _Windows):
    """Windows in device memory, shared through CUDA IPC."""

    transport = "cuda-ipc"

    def __init__(self, n: int, local: dict, slot_bytes: int, store, prefix: str):
        super().__init__(n, local, slot_bytes)
        from ..ops.cuda_q40 import load_kernel

        v = ctypes.c_void_p
        self._alloc = load_kernel(rc.KERNEL, [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.POINTER(v), ctypes.c_char_p],
                                  "ring_window_alloc")
        self._open = load_kernel(rc.KERNEL, [ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(v)],
                                 "ring_window_open")
        self._release = load_kernel(rc.KERNEL, [ctypes.c_int, v, ctypes.c_int],
                                    "ring_window_release")
        self._put = load_kernel(rc.KERNEL, [ctypes.c_int, v, ctypes.POINTER(ctypes.c_uint),
                                         ctypes.c_int], "ring_window_put")
        self._load_stream_ops()
        self.base: dict = {}  # global rank -> its window's address in this process
        self._own: dict = {}
        self._opened: list = []
        size = window_bytes(self.slot_bytes)
        first = (ctypes.c_uint * NSLOTS)(*self._first_values())
        for r, dev in self.local.items():
            ptr, handle = v(), ctypes.create_string_buffer(64)
            _check(self._alloc(dev.index, size, ctypes.byref(ptr), handle), "cudaMalloc/IPC handle")
            self._own[r] = (dev.index, ptr.value)
            for off in (READY_OFF, CONSUMED_OFF):
                _check(self._put(dev.index, ptr.value + off, first, NSLOTS), "window words")
            self.base[r] = ptr.value
            store.set(f"{prefix}/cuda/{r}", handle.raw)
        # a peer's window opens on the device of the local rank that reads
        # it (the receiver r + 1) or writes its words (the sender r - 1)
        dev0 = next(iter(self.local.values()))
        for r in range(n):
            if r in self.local:
                continue
            user = self.local.get((r + 1) % n) or self.local.get((r - 1) % n) or dev0
            handle = store.get(f"{prefix}/cuda/{r}")
            ptr = v()
            _check(self._open(user.index, handle, ctypes.byref(ptr)),
                   f"cudaIpcOpenMemHandle of rank {r}'s window")
            self.base[r] = ptr.value
            self._opened.append((user.index, ptr.value))

    def slot_ptr(self, r: int, slot: int, off: int) -> int:
        return self.base[r] + self.slot_offset(slot, off)

    def _stream(self, r: int):
        return torch.cuda.current_stream(self.local[r])

    def _stage(self, sender: int, slot: int, wire: list, stream) -> None:
        """One copy launch of the ring-step kernel: the wire segments into
        the sender's slot."""
        rc.launch_descs(self.local[sender], stream,
                        [rc.stage_desc(seg.src, self.slot_ptr(sender, slot, off))
                         for seg, off, _ in wire], 0)

    def _pull(self, sender: int, r: int, slot: int, wire: list, own: list, stream) -> None:
        """The receiver's launch: the wire segments read from the sender's
        slot, with its own (non-wire) segments."""
        descs = [rc.pull_desc(self.slot_ptr(sender, slot, off), seg.dst, seg.add)
                 for seg, off, _ in wire]
        rc.launch_descs(self.local[r], stream, descs + [rc.seg_desc(s) for s in own],
                        sum(b for _, _, b in wire))

    def _word(self, r: int, kind_off: int, slot: int) -> int:
        """Rank r's word: a wait reads a local rank's, a post writes a
        peer's."""
        return self.base[r] + kind_off + WORD * slot

    def close(self) -> None:
        for dev, ptr in self._opened:
            self._release(dev, ptr, 0)
        for dev, ptr in self._own.values():
            self._release(dev, ptr, 1)
        self._opened, self._own = [], {}


def _spin(ready, check) -> None:
    """This thread polls ``ready()`` until it holds: 64 polls that only
    yield, then 0.1 ms naps; ``check()`` runs before each poll (it raises
    to give the wait up)."""
    spins = 0
    while not ready():
        check()
        spins += 1
        time.sleep(0 if spins < 64 else 0.0001)


class _SpinWords:
    """The CPU's waits and flag writes: this thread spins on the word
    ``self._host_word(r, kind_off, slot)`` gives ((array, index)), running
    ``self._wait_check(r, kind_off)`` between polls, and the ms it spun
    while timed."""

    _timed_ms = 0.0

    def wait(self, r: int, kind_off: int, slot: int, value: int, stream=None) -> None:
        self.stats["waits"] += 1
        words, i = self._host_word(r, kind_off, slot)
        want = value & MASK32
        t0 = time.perf_counter()
        _spin(lambda: int(words[i]) & MASK32 == want, self._wait_check(r, kind_off))
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["wait_ms"] += ms
        if self.timing:
            self._timed_ms += ms

    def post(self, r: int, kind_off: int, slot: int, value: int, stream=None) -> None:
        words, i = self._host_word(r, kind_off, slot)
        words[i] = value & MASK32

    def start_timing(self) -> None:
        self._timed_ms = 0.0
        self.timing = True

    def stop_timing(self) -> float:
        self.timing = False
        return self._timed_ms


class FileWindows(_SpinWords, _Windows):
    """Windows in one shared-memory file a rank (the CPU's plain path)."""

    transport = "shared-memory files"

    def __init__(self, n: int, local: dict, slot_bytes: int, store, prefix: str):
        super().__init__(n, local, slot_bytes)
        size = window_bytes(self.slot_bytes)
        self.view: dict = {}  # global rank -> uint8 tensor over its window
        self._pids: dict = {}
        paths = []
        for r in self.local:
            fd, path = tempfile.mkstemp(prefix=f"dllama_pod_rank{r}_")
            with os.fdopen(fd, "wb") as f:
                f.truncate(size)
            paths.append(path)
            self.view[r] = self._map(path, size)
            words = self._words(r)
            words[READY_OFF // 8: READY_OFF // 8 + NSLOTS] = torch.tensor(self._first_values())
            words[CONSUMED_OFF // 8: CONSUMED_OFF // 8 + NSLOTS] = torch.tensor(
                self._first_values())
            store.set(f"{prefix}/file/{r}", f"{os.getpid()} {path}")
        for r in range(n):
            if r not in self.local:
                pid, path = store.get(f"{prefix}/file/{r}").decode().split(" ", 1)
                self._pids[r] = int(pid)
                self.view[r] = self._map(path, size)
        # every process has mapped every window (each counts its ranks):
        # the files can go
        store.add(f"{prefix}/mapped", len(self.local))
        while int(store.add(f"{prefix}/mapped", 0)) < n:
            time.sleep(0.01)
        for path in paths:
            os.unlink(path)

    @staticmethod
    def _map(path: str, size: int) -> torch.Tensor:
        storage = torch.UntypedStorage.from_file(path, shared=True, nbytes=size)
        return torch.tensor([], dtype=torch.uint8).set_(storage)

    def _words(self, r: int) -> torch.Tensor:
        # int64 words on the CPU (no wrap): word i of kind k at byte k + 8 i
        return self.view[r][:CTRL_BYTES].view(torch.int64)

    def slot_view(self, r: int, slot: int, off: int, nbytes: int) -> torch.Tensor:
        start = self.slot_offset(slot, off)
        return self.view[r][start:start + nbytes]

    def _typed(self, r: int, slot: int, off: int, like: torch.Tensor) -> torch.Tensor:
        """Rank r's slot bytes at ``off`` as a tensor shaped like ``like``."""
        nbytes = like.numel() * like.element_size()
        return self.slot_view(r, slot, off, nbytes).view(like.dtype).view(like.shape)

    def _stream(self, r: int):
        return None

    def _stage(self, sender: int, slot: int, wire: list, stream) -> None:
        rc.plain_step([[rc.Seg(seg.src, self._typed(sender, slot, off, seg.src))
                        for seg, off, _ in wire]], 0)

    def _pull(self, sender: int, r: int, slot: int, wire: list, own: list, stream) -> None:
        got = [seg._replace(src=self._typed(sender, slot, off, seg.dst)) for seg, off, _ in wire]
        rc.plain_step([got + own], sum(b for _, _, b in wire))

    def _host_word(self, r: int, kind_off: int, slot: int) -> tuple:
        return self._words(r), kind_off // 8 + slot

    def _wait_check(self, r: int, kind_off: int):
        """A wait's check: every ``_LIVENESS_S``, that the peer on the
        other end of the word is alive."""
        peer = (r - 1) % self.n if kind_off == READY_OFF else (r + 1) % self.n
        pid = self._pids.get(peer)
        check_at = [time.perf_counter() + _LIVENESS_S]

        def check() -> None:
            now = time.perf_counter()
            if pid is not None and now >= check_at[0]:
                check_at[0] = now + _LIVENESS_S
                if not alive(pid):
                    raise PodPeerLost(f"rank {peer}'s process ({pid}) died during a ring step")
        return check

    def close(self) -> None:
        self.view = {}


class _Closed(Exception):
    """The windows closed while a transport thread waited."""


class _Link:
    """This process's end of ring link ``rank`` (rank - 1 -> rank): its
    socket, its buffer (the window layout) and the jobs its transport
    thread takes, one a ring step: (epoch, slot, bytes)."""

    def __init__(self, rank: int, outgoing: bool, device: torch.device, nbytes: int, alloc):
        self.rank = rank
        self.outgoing = outgoing  # this process holds the sender
        self.sock = None
        self.jobs: queue.Queue = queue.Queue()
        self.send_lock = threading.Lock()
        self.threads: list = []
        self.host_ptr, self.dev_ptr, self.buf = alloc(device, nbytes)
        self.words = self.buf[:CTRL_BYTES].view(np.uint32)
        self.tensor = torch.from_numpy(self.buf)  # the CPU's staging and pulls


class SocketWindows(_SpinWords, _Windows):
    """Ring links over TCP, so that a pod's processes may run on different
    hosts (the module docstring): the CPU's form, whose buffers are host
    memory, whose steps are the plain ring step and whose waits spin
    (``CudaSocketWindows``: the card's). ``address``: (the address this
    process's links listen at, the one its peers connect to).
    ``on_lost(detail)`` runs on a transport thread when a link fails (None:
    the failure is raised by this process's next wait)."""

    transport = "socket"

    def __init__(self, n: int, local: dict, slot_bytes: int, store, prefix: str,
                 address: tuple = ("127.0.0.1", "127.0.0.1"), on_lost=None):
        super().__init__(n, local, slot_bytes)
        self.on_lost = on_lost
        self.lost: PodPeerLost | None = None
        self.closing = threading.Event()
        size = window_bytes(self.slot_bytes)
        # link r is rank r - 1 -> rank r; this process holds one end of it
        # where exactly one of the two ranks is local
        self.links: dict = {}
        for r in range(n):
            sender = (r - 1) % n
            if (sender in self.local) != (r in self.local):
                out = sender in self.local
                dev = self.local[sender if out else r]
                self.links[r] = _Link(r, out, dev, size, self._alloc)
                for off in (READY_OFF, CONSUMED_OFF):
                    self.links[r].words[off // WORD: off // WORD + NSLOTS] = self._first_values()
        inbound = [link for link in self.links.values() if not link.outgoing]
        listen, publish = address
        listener = _listen(listen, len(inbound))
        try:
            port = listener.getsockname()[1]
            for link in inbound:
                store.set(f"{prefix}/sock/{link.rank}", f"{publish}:{port}")
            for link in self.links.values():
                if link.outgoing:
                    addr = store.get(f"{prefix}/sock/{link.rank}").decode()
                    link.sock = _connect(addr, FRAME.pack(FRAME_MAGIC, link.rank, 0, 0))
            for _ in inbound:
                sock, hello = _accept(listener, FRAME.size)
                magic, rank, _, _ = FRAME.unpack(hello)
                link = self.links.get(rank)
                if magic != FRAME_MAGIC or link is None or link.outgoing or link.sock:
                    sock.close()
                    raise PodPeerLost(f"a pod link's hello names rank {rank}: not a ring "
                                      "link into this process")
                link.sock = sock
        finally:
            listener.close()
        for link in self.links.values():
            jobs = ((self._send_loop, "send"), (self._hangup_loop, "peer")) if link.outgoing \
                else ((self._recv_loop, "recv"),)
            for fn, what in jobs:
                t = threading.Thread(target=self._run, args=(fn, link),
                                     name=f"pod-link{link.rank}-{what}", daemon=True)
                t.start()
                link.threads.append(t)

    # -- memory --------------------------------------------------------------

    def _alloc(self, device: torch.device, nbytes: int) -> tuple:
        """(host address, device address, uint8 array over it) of a link's
        buffer: plain host memory here (addresses 0)."""
        return 0, 0, np.zeros(nbytes, np.uint8)

    def _free(self, link: _Link) -> None:
        """A link's buffer goes (numpy's, here)."""

    def _word_index(self, r: int, kind_off: int, slot: int) -> tuple:
        """(link, word index) of rank r's word: a ready word is the link
        into r's, a consumed word the link out of r's (each end owns its
        own copy of both)."""
        link = self.links[r if kind_off == READY_OFF else (r + 1) % self.n]
        return link, kind_off // WORD + slot

    def _host_word(self, r: int, kind_off: int, slot: int) -> tuple:
        link, i = self._word_index(r, kind_off, slot)
        return link.words, i

    def _slot(self, link: _Link, slot: int, off: int, nbytes: int) -> memoryview:
        start = self.slot_offset(slot, off)
        return memoryview(link.buf)[start:start + nbytes]

    def _typed(self, link: _Link, slot: int, off: int, like: torch.Tensor) -> torch.Tensor:
        start = self.slot_offset(slot, off)
        nbytes = like.numel() * like.element_size()
        return link.tensor[start:start + nbytes].view(like.dtype).view(like.shape)

    # -- the ring step's device half ------------------------------------------

    def _stream(self, r: int):
        return None

    def _announce(self, e: int, slot: int, stage: list, pull: list) -> None:
        for _, r, wire in stage + pull:
            self.links[r].jobs.put((e, slot, _span(wire)))

    def _stage(self, sender: int, slot: int, wire: list, stream) -> None:
        """The wire segments into the sender's own slot of its outgoing
        link (the plain copy)."""
        link = self.links[(sender + 1) % self.n]
        rc.plain_step([[rc.Seg(seg.src, self._typed(link, slot, off, seg.src))
                        for seg, off, _ in wire]], 0)

    def _pull(self, sender: int, r: int, slot: int, wire: list, own: list, stream) -> None:
        """The receiver's pull from the slot its receive thread filled,
        with its own (non-wire) segments (the plain ring step)."""
        link = self.links[r]
        got = [seg._replace(src=self._typed(link, slot, off, seg.dst)) for seg, off, _ in wire]
        rc.plain_step([got + own], sum(b for _, _, b in wire))

    def _wait_check(self, r: int, kind_off: int):
        """A wait's check: a lost link raises."""
        def check() -> None:
            if self.lost is not None:
                raise self.lost
        return check

    # -- the transport threads -------------------------------------------------

    def _run(self, fn, link: _Link) -> None:
        try:
            fn(link)
        except _Closed:
            pass
        except (PodPeerLost, OSError) as e:
            if not self.closing.is_set():
                self._fail(link, e)

    def _fail(self, link: _Link, err: Exception) -> None:
        lost = err if isinstance(err, PodPeerLost) else PodPeerLost(
            f"pod link {(link.rank - 1) % self.n} -> {link.rank} failed: "
            f"{type(err).__name__}: {err}")
        # a pod's handler ends the process here (or returns: it is leaving);
        # only then may a waiting ring step raise it
        if self.on_lost is not None:
            self.on_lost(str(lost))
        if self.lost is None:
            self.lost = lost

    def _job(self, link: _Link) -> tuple:
        while True:
            try:
                return link.jobs.get(timeout=POLL_S)
            except queue.Empty:
                if self.closing.is_set():
                    raise _Closed from None

    def _poll(self, link: _Link, i: int, value: int) -> None:
        """This transport thread waits until ``link``'s word i reads
        ``value``."""
        want = value & MASK32
        _spin(lambda: int(link.words[i]) == want, self._closed_check)

    def _closed_check(self) -> None:
        if self.closing.is_set():
            raise _Closed

    def _send_loop(self, link: _Link) -> None:
        """The sender's end: for each step, once the stream has staged the
        slot (its ready word), the frame out, then the slot is free again
        (its consumed word)."""
        while True:
            e, slot, nbytes = self._job(link)
            self._poll(link, READY_OFF // WORD + slot, e)
            with link.send_lock:
                _send_all(link.sock, FRAME.pack(FRAME_MAGIC, e & MASK32, slot, nbytes))
                _send_all(link.sock, self._slot(link, slot, 0, nbytes))
            link.words[CONSUMED_OFF // WORD + slot] = e & MASK32

    def _hangup_loop(self, link: _Link) -> None:
        """The sender's end of the link's other direction: nothing comes
        back on it but the receiver's goodbye; EOF without one is a lost
        peer."""
        head = bytearray(FRAME.size)
        if not _recv_frame_start(link.sock, head, self.closing):
            raise _Closed
        magic, _, slot, _ = FRAME.unpack(head)
        if magic == FRAME_MAGIC and slot == BYE:
            raise _Closed
        raise PodPeerLost(f"pod link into rank {link.rank}: the receiver sent a frame "
                          "where only its goodbye may come")

    def _recv_loop(self, link: _Link) -> None:
        """The receiver's end: each frame's header checked against the step
        it must carry, the slot's last pull waited for (its consumed word),
        the payload read into the slot, then its ready word."""
        head = bytearray(FRAME.size)
        while True:
            if not _recv_frame_start(link.sock, head, self.closing):
                raise _Closed
            magic, epoch, slot, nbytes = FRAME.unpack(head)
            if magic == FRAME_MAGIC and slot == BYE:
                raise _Closed
            e, want_slot, want_bytes = self._job(link)
            check_frame(head, e, want_slot, want_bytes)
            self._poll(link, CONSUMED_OFF // WORD + slot, e - NSLOTS)
            _recv_exact(link.sock, self._slot(link, slot, 0, nbytes))
            link.words[READY_OFF // WORD + slot] = e & MASK32

    def close(self) -> None:
        """Say goodbye on every link (the peers' threads end without a
        loss), stop the threads and free the buffers."""
        self.closing.set()
        for link in self.links.values():
            try:
                with link.send_lock:
                    _send_all(link.sock, FRAME.pack(FRAME_MAGIC, 0, BYE, 0))
            except (OSError, PodPeerLost):
                pass
        for link in self.links.values():
            for t in link.threads:
                t.join(timeout=5)
            link.sock.close()
            self._free(link)
        self.links = {}


class CudaSocketWindows(_StreamWords, SocketWindows):
    """``SocketWindows`` on the card: each link's buffer is pinned host
    memory mapped into the device, the sender's staging and the receiver's
    pull are one ring-step launch each on that memory, the streams' waits
    and flag writes are stream memory operations on its words, and a
    transport thread's wait on a word the stream writes spins in C
    (``ring_host_wait``), without the Python lock."""

    def __init__(self, *args, **kwargs):
        from ..ops.cuda_q40 import load_kernel

        self._load_stream_ops()
        v = ctypes.c_void_p
        self._host_alloc = load_kernel(rc.KERNEL, [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.POINTER(v), ctypes.POINTER(v)],
                                       "ring_host_alloc")
        self._host_free = load_kernel(rc.KERNEL, [v], "ring_host_free")
        self._host_wait = load_kernel(rc.KERNEL, [v, ctypes.c_uint, ctypes.c_longlong],
                                      "ring_host_wait")
        super().__init__(*args, **kwargs)

    def _alloc(self, device: torch.device, nbytes: int) -> tuple:
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _check(self._host_alloc(device.index, nbytes, ctypes.byref(host), ctypes.byref(dev)),
               "cudaHostAlloc (mapped) of a socket link's buffer")
        raw = (ctypes.c_uint8 * nbytes).from_address(host.value)
        return host.value, dev.value, np.frombuffer(raw, np.uint8)

    def _free(self, link: _Link) -> None:
        self._host_free(link.host_ptr)

    def _word(self, r: int, kind_off: int, slot: int) -> int:
        link, i = self._word_index(r, kind_off, slot)
        return link.dev_ptr + WORD * i

    def _stream(self, r: int):
        return torch.cuda.current_stream(self.local[r])

    def _stage(self, sender: int, slot: int, wire: list, stream) -> None:
        link = self.links[(sender + 1) % self.n]
        rc.launch_descs(self.local[sender], stream,
                        [rc.stage_desc(seg.src, link.dev_ptr + self.slot_offset(slot, off))
                         for seg, off, _ in wire], 0)

    def _pull(self, sender: int, r: int, slot: int, wire: list, own: list, stream) -> None:
        link = self.links[r]
        descs = [rc.pull_desc(link.dev_ptr + self.slot_offset(slot, off), seg.dst, seg.add)
                 for seg, off, _ in wire]
        rc.launch_descs(self.local[r], stream, descs + [rc.seg_desc(s) for s in own],
                        sum(b for _, _, b in wire))

    def _poll(self, link: _Link, i: int, value: int) -> None:
        addr = link.host_ptr + WORD * i
        while self._host_wait(addr, value & MASK32, int(POLL_S * 1e6)) != 0:
            self._closed_check()


def check_frame(head: bytes, epoch: int, slot: int, nbytes: int) -> None:
    """Raise ``PodPeerLost`` unless a socket link's frame header is the
    magic, ``epoch`` (mod 2**32), ``slot`` and ``nbytes``: a torn or
    out-of-order frame is never read into a slot."""
    got = FRAME.unpack(bytes(head))
    want = (FRAME_MAGIC, epoch & MASK32, slot, nbytes)
    if got != want:
        raise PodPeerLost(f"pod link frame header {got} (magic, epoch, slot, bytes), "
                          f"expected {want}")


def _tune(sock: socket.socket) -> socket.socket:
    """A link's socket: no Nagle delay, keepalive probes (a peer host that
    vanishes without closing is found within about 25 s), non-blocking
    (every wait is a poll with a timeout)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, value in (("TCP_KEEPIDLE", 10), ("TCP_KEEPINTVL", 5), ("TCP_KEEPCNT", 3)):
        if hasattr(socket, opt):
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), value)
    sock.setblocking(False)
    return sock


def _listen(host: str, backlog: int) -> socket.socket:
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind((host, 0))
    listener.listen(max(1, backlog))
    return listener


def _connect(addr: str, hello: bytes) -> socket.socket:
    """A connection to a peer's listener at ``host:port``, its hello sent.
    Raises (no retry through another path) if it cannot connect."""
    host, _, port = addr.rpartition(":")
    try:
        sock = socket.create_connection((host, int(port)), timeout=CONNECT_TIMEOUT_S)
    except OSError as e:
        raise PodPeerLost(f"cannot connect a pod link to {addr}: {e}") from e
    _tune(sock)
    _send_all(sock, hello)
    return sock


def _accept(listener: socket.socket, hello_bytes: int) -> tuple:
    """The next peer's connection on ``listener`` and its hello."""
    listener.settimeout(CONNECT_TIMEOUT_S)
    try:
        sock, _ = listener.accept()
    except OSError as e:
        raise PodPeerLost(f"no pod link connected within {CONNECT_TIMEOUT_S:.0f} s: {e}") from e
    _tune(sock)
    hello = bytearray(hello_bytes)
    _recv_exact(sock, memoryview(hello))
    return sock, bytes(hello)


def _io_ready(sock: socket.socket, write: bool, timeout: float) -> bool:
    poller = select.poll()
    poller.register(sock, select.POLLOUT if write else select.POLLIN)
    return bool(poller.poll(timeout * 1e3))


def _send_all(sock: socket.socket, data) -> None:
    view = memoryview(data).cast("B")
    sent = 0
    while sent < len(view):
        if not _io_ready(sock, True, FRAME_TIMEOUT_S):
            raise PodPeerLost(f"a pod link took no bytes for {FRAME_TIMEOUT_S:.0f} s")
        try:
            sent += sock.send(view[sent:])
        except BlockingIOError:
            continue


def _recv_exact(sock: socket.socket, view) -> None:
    """Fill ``view`` from ``sock``; EOF or a stall of FRAME_TIMEOUT_S
    inside it is a lost peer."""
    view = memoryview(view).cast("B")
    got = 0
    while got < len(view):
        if not _io_ready(sock, False, FRAME_TIMEOUT_S):
            raise PodPeerLost(f"a pod link stalled inside a frame for {FRAME_TIMEOUT_S:.0f} s")
        try:
            k = sock.recv_into(view[got:])
        except BlockingIOError:
            continue
        if k == 0:
            raise PodPeerLost("a pod link's peer closed it inside a frame")
        got += k


def _recv_frame_start(sock: socket.socket, head: bytearray, closing: threading.Event) -> bool:
    """Wait, however long, for the next frame's header and read it (False
    once ``closing`` is set). EOF before a header is a lost peer."""
    while True:
        while not _io_ready(sock, False, POLL_S):
            if closing.is_set():
                return False
        try:
            k = sock.recv_into(head)
            break
        except BlockingIOError:
            continue
    if k == 0:
        raise PodPeerLost("a pod link's peer closed it")
    if k < len(head):
        _recv_exact(sock, memoryview(head)[k:])
    return True


def alive(pid: int) -> bool:
    """Whether process ``pid`` of this host runs (a zombie does not)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return True


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"pod window: {what} failed (CUDA error {err})")


def open_windows(n: int, local: dict, slot_bytes: int, store, prefix: str = "pod/win"):
    """The pod's windows: one of this process's local ranks (``local``:
    global rank -> device) each, every other rank's opened, over the
    transport the pod chose when it joined (``multihost.pod_transport``:
    sockets, or CUDA IPC on the card and files on the CPU); collective over
    the pod (every process calls it with the same ``n``, ``slot_bytes`` and
    ``prefix``)."""
    from . import multihost

    devs = set(d.type for d in local.values())
    if devs - {"cuda", "cpu"} or len(devs) != 1:
        raise ValueError(f"a pod's local ranks lie on one device type, not {sorted(devs)}")
    if multihost.pod_transport() == "socket":
        cls = CudaSocketWindows if devs == {"cuda"} else SocketWindows
        return cls(n, local, slot_bytes, store, prefix, address=multihost.pod_address(),
                   on_lost=multihost.peer_lost)
    if devs == {"cuda"}:
        return CudaWindows(n, local, slot_bytes, store, prefix)
    return FileWindows(n, local, slot_bytes, store, prefix)

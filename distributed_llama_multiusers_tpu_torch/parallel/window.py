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
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import time

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


class PodPeerLost(RuntimeError):
    """A peer process of the pod died while this one waited for it."""


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
                self.check_fits(wire[-1][1] + wire[-1][2])
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

    @staticmethod
    def _first_values() -> list:
        """The words' values before the first step: slot s's last use was
        epoch s, already consumed, and no ready word reads an epoch >=
        NSLOTS."""
        return list(range(NSLOTS))


class CudaWindows(_Windows):
    """Windows in device memory, shared through CUDA IPC."""

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
        self._wait_fn = load_kernel(rc.KERNEL, [v, v, ctypes.c_uint], "ring_wait_value")
        self._write_fn = load_kernel(rc.KERNEL, [v, v, ctypes.c_uint], "ring_write_value")
        self.base: dict = {}  # global rank -> its window's address in this process
        self._own: dict = {}
        self._opened: list = []
        self._timed: list = []
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
        return self.base[r] + kind_off + WORD * slot

    def wait(self, r: int, kind_off: int, slot: int, value: int, stream) -> None:
        """``stream`` waits until rank r's (local) word reads ``value``."""
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
        """``stream`` writes ``value`` into rank r's (a peer's) word, after
        the work before it."""
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

    def close(self) -> None:
        for dev, ptr in self._opened:
            self._release(dev, ptr, 0)
        for dev, ptr in self._own.values():
            self._release(dev, ptr, 1)
        self._opened, self._own = [], {}


class FileWindows(_Windows):
    """Windows in one shared-memory file a rank (the CPU's plain path)."""

    def __init__(self, n: int, local: dict, slot_bytes: int, store, prefix: str):
        super().__init__(n, local, slot_bytes)
        size = window_bytes(self.slot_bytes)
        self.view: dict = {}  # global rank -> uint8 tensor over its window
        self._pids: dict = {}
        self._timed_ms = 0.0
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

    def wait(self, r: int, kind_off: int, slot: int, value: int, stream=None) -> None:
        """Spin until rank r's (local) word reads ``value``, checking that
        the peer on the other end of that word is alive."""
        self.stats["waits"] += 1
        word = self._words(r)[kind_off // 8 + slot:kind_off // 8 + slot + 1]
        peer = (r - 1) % self.n if kind_off == READY_OFF else (r + 1) % self.n
        t0 = time.perf_counter()
        check_at = t0 + _LIVENESS_S
        spins = 0
        while int(word[0]) != value:
            spins += 1
            if spins > 64:
                time.sleep(0.0001)
            now = time.perf_counter()
            if now >= check_at and peer in self._pids:
                check_at = now + _LIVENESS_S
                if not alive(self._pids[peer]):
                    raise PodPeerLost(f"rank {peer}'s process ({self._pids[peer]}) died "
                                      "during a ring step")
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["wait_ms"] += ms
        if self.timing:
            self._timed_ms += ms

    def post(self, r: int, kind_off: int, slot: int, value: int, stream=None) -> None:
        self._words(r)[kind_off // 8 + slot] = value

    def start_timing(self) -> None:
        self._timed_ms = 0.0
        self.timing = True

    def stop_timing(self) -> float:
        self.timing = False
        return self._timed_ms

    def close(self) -> None:
        self.view = {}


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
    global rank -> device) each, every other rank's opened; collective over
    the pod (every process calls it with the same ``n``, ``slot_bytes`` and
    ``prefix``)."""
    devs = set(d.type for d in local.values())
    if devs == {"cuda"}:
        return CudaWindows(n, local, slot_bytes, store, prefix)
    if devs == {"cpu"}:
        return FileWindows(n, local, slot_bytes, store, prefix)
    raise ValueError(f"a pod's local ranks lie on one device type, not {sorted(devs)}")

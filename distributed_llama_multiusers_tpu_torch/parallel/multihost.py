"""Multi-process serving (a pod): the ``torch.distributed`` bootstrap and the
root->worker control plane (the JAX package's ``parallel/multihost.py``).

Reference mapping (src/app.cpp):
- cluster bootstrap (worker ``serve()`` and the root connecting and shipping
  configs, src/app.cpp:405-464) -> ``maybe_initialize_distributed``: every
  process runs the same program and loads the model file itself
  (parallel/sharding.py keeps its own ranks' shards), then joins a gloo
  process group over a TCP store. No weight crosses the wire.
- ``LlmControlPacket{position, batchSize}`` written to every worker before
  each forward (src/app.cpp:198-209) -> ``ControlPlane``: a fixed-size int32
  packet broadcast from process 0 per engine call, carrying the op and its
  host-side arguments; ``OP_STOP`` is batchSize = 0's stop signal.
- the worker's poll loop (src/app.cpp:218-231) -> ``worker_loop``: receive
  a packet, replay the identical engine call, so that every process runs
  the same ring steps in the same order.

Gloo carries the packets and the bootstrap's handle exchange only. The
activations cross processes through the ring hop kernel reading a peer's
window (parallel/window.py, ops/ring_collective.py). The data plane's
transport is chosen once, at the join (``pod_transport``): CUDA IPC on the
card or shared-memory files on the CPU when every process runs on one host,
TCP sockets between the processes when they run on different hosts (or
when ``DLLAMA_POD_TRANSPORT=socket`` asks for them on one). A dead peer is
found by a pid watcher on one host's shared memory, and by the links
themselves over sockets (EOF, a reset, a frame that stalls or tears);
either ends the process with ``POD_LOST_EXIT_CODE``.

The pod-deadlock rule: in every ``RootControlEngine`` method argument
validation runs BEFORE the packet broadcast, and no ``raise`` or early
``return`` is reachable between a ``self._plane.send_*`` broadcast and its
paired ``self._engine`` call. A packet with no root-side compute leaves
every worker inside a ring step the root never takes. Nothing is broadcast
while a lock is held.

The packet layout (magic, version, op numbers, HEADER, SLOTS and the slot
sizing) is the JAX package's, word for word, at its protocol version 6,
the paged KV ops included: OP_KV_TABLE (a lane's table row and its
copy-on-write pairs, lane -1 the reset), OP_KV_PAGES (a disaggregated
hand-off's page import) and OP_KV_SWAP (a host swap tier batch). The pool's
bookkeeping is host state and runs on the root only; a worker keeps a pool
for its geometry alone. Page payloads are whole pages, every rank's heads:
each process writes its own ranks' heads, and the root reads its peers'
heads of a page it exports or swaps out straight from their pool planes
(parallel/kvshare.py), which no packet carries. A process whose KV layout
differs from its peers' stops at startup (``agree``), and a worker that
receives a paged op on a contiguous engine raises ``ReplayError``.
"""

from __future__ import annotations

import ipaddress
import json
import os
import socket
import threading
import time
from datetime import timedelta

import numpy as np
import torch

from ..ops import reset_kernel_counts
from ..telemetry.logs import log_event
from ..utils import faults
from .window import PodPeerLost, alive

# Control-packet integrity word: every packet leads with a magic constant
# and the protocol version, validated on recv before the op dispatch, so a
# torn packet or a version-skewed peer is a classified ReplayError.
PACKET_MAGIC = 0x444C4C41  # "DLLA"
PROTOCOL_VERSION = 6  # the JAX package's version: the same layout and ops

OP_STOP = 0
OP_PREFILL = 1
OP_DECODE = 2
OP_DECODE_SPEC = 3
OP_STATS_RESET = 4  # zero worker-side counters (post-warmup hygiene)
OP_COPY_LANE = 5  # prefix caching: copy one lane's KV into another
OP_DECODE_MULTI = 6  # h chained decode steps in one dispatch (h in header)
OP_DECODE_PIPELINED = 7  # a pipelined step: feed flag + ring depth in header
OP_PIPELINE_FLUSH = 8  # the root ended or aborted a pipelined chain
OP_DECODE_PREFILL_FUSED = 9  # a prompt chunk and a pipelined step together
OP_DECODE_SPEC_PIPELINED = 10  # a verify step inside the pipelined ring
OP_DECODE_SPEC_PREFILL_FUSED = 11  # a prompt chunk and an in-ring verify step
OP_KV_TABLE = 12  # paged KV table row + COW copies (lane -1: unmap every lane)
OP_GRAMMAR = 13  # a response_format's canonical JSON (or a detach key)
OP_KV_PAGES = 14  # disaggregated prefill's page import, in payload fragments
OP_KV_SWAP = 15  # the host swap tier's page batch, in payload fragments
_PAGED_OPS = {OP_KV_TABLE: "OP_KV_TABLE", OP_KV_PAGES: "OP_KV_PAGES", OP_KV_SWAP: "OP_KV_SWAP"}

# a worker idles inside the packet broadcast while the root serves no
# request: the process group's timeout only ends a root that is alive and
# silent for this long (a dead root closes its sockets at once)
POD_TIMEOUT = timedelta(days=7)
# how long the bootstrap waits for every process to join and publish
BOOTSTRAP_TIMEOUT = timedelta(minutes=30)
# a pod process that lost a peer exits with this code
POD_LOST_EXIT_CODE = 18
# how often a pod process checks that its peers (same host) are alive
PEER_CHECK_S = 0.5
# a socket link that ends while this process is leaving the pod is no
# failure; a peer that stops on purpose may close its links just before this
# process reads its stop packet, so a lost link waits this long to see it
LEAVE_GRACE_S = 0.5
# forces the socket transport on one host (tests, tools, the smoke)
TRANSPORT_ENV = "DLLAMA_POD_TRANSPORT"


class ReplayError(RuntimeError):
    """Classified control-plane replay failure: the packet itself is bad
    (magic/version mismatch, unknown or refused op), detected before any
    engine dispatch, so no ring step was entered and the pod cannot have
    desynced on it. ``worker_serve`` does not burn its restart budget on
    these."""


class PodLost(RuntimeError):
    """The packet broadcast failed: a process of the pod is gone."""


_JOINED: dict = {}  # "store", "process_index", "num_processes" once joined
_LEAVING = threading.Event()  # this process is leaving the pod on purpose


def requested_pod(args=None):
    """(coordinator, process count, process id) the flags or variables ask
    for, or None outside a pod: ``--coordinator host:port --num-processes N
    --process-id I``, or ``DLLAMA_COORDINATOR`` / ``DLLAMA_NUM_PROCESSES`` /
    ``DLLAMA_PROCESS_ID``."""
    coord = getattr(args, "coordinator", None) or os.environ.get("DLLAMA_COORDINATOR")
    if not coord:
        return None
    n = int(getattr(args, "num_processes", None)
            or os.environ.get("DLLAMA_NUM_PROCESSES", "0"))
    pid_attr = getattr(args, "process_id", None)
    pid = int(pid_attr if pid_attr is not None else os.environ.get("DLLAMA_PROCESS_ID", "-1"))
    if n <= 0 or pid < 0:
        raise ValueError(
            "--coordinator requires --num-processes and --process-id "
            "(or the DLLAMA_* env equivalents)"
        )
    return coord, n, pid


def maybe_initialize_distributed(args=None) -> int:
    """Join a pod when the coordinator flags or variables are present
    (``requested_pod``); returns the process count (1 when not
    distributed). Process 0 serves the TCP store at the coordinator's
    ``host:port``; every process joins a gloo process group over it,
    publishes its hostname and takes the pod's data-plane transport
    (``pod_transport``; every process must take the same, or ``agree``
    raises ``ReplayError``). The pid watcher arms only where the processes
    share one host's memory: over sockets the links find a dead peer. Over
    sockets each process publishes the address its links listen at
    (``link_addresses``); an address that resolves to loopback on a peer's
    host raises ``ValueError`` on every process."""
    req = requested_pod(args)
    if req is None:
        return 1
    coord, n, pid = req
    if _JOINED:
        return _JOINED["num_processes"]
    forced = os.environ.get(TRANSPORT_ENV, "")
    if forced not in ("", "socket"):
        raise ValueError(f"{TRANSPORT_ENV}={forced!r}: the only transport it can force is "
                         "'socket'")
    host, _, port = coord.rpartition(":")
    store = torch.distributed.TCPStore(host, int(port), n, pid == 0,
                                       timeout=BOOTSTRAP_TIMEOUT)
    torch.distributed.init_process_group("gloo", store=store, world_size=n, rank=pid,
                                         timeout=POD_TIMEOUT)
    store.set(f"pod/host/{pid}", socket.gethostname())
    store.set(f"pod/pid/{pid}", str(os.getpid()))
    _JOINED.update(store=store, process_index=pid, num_processes=n)
    hosts = pod_hostnames()
    transport = "socket" if forced or len(set(hosts)) > 1 else "shared"
    _JOINED["transport"] = transport
    agree("pod/transport", transport)
    if transport == "shared":
        _watch_peers({i: int(store.get(f"pod/pid/{i}")) for i in range(n) if i != pid})
        return n
    listen, publish = link_addresses(host, routed_address(host, int(port)), len(set(hosts)) > 1)
    _JOINED.update(listen=listen, address=publish)
    store.set(f"pod/addr/{pid}", publish)
    # each process resolves its peers' addresses as it will connect to them;
    # a process on another host that publishes loopback is unreachable, and
    # every process stops on it, not only the one that found it
    problems = []
    for i in range(n):
        addr = store.get(f"pod/addr/{i}").decode()
        why = _unreachable(addr) if hosts[i] != hosts[pid] else ""
        if why:
            problems.append(f"process {i} on {hosts[i]} publishes {addr}, which resolves "
                            f"to {why} on {hosts[pid]}")
    store.set(f"pod/addr_ok/{pid}", "; ".join(problems))
    found = [store.get(f"pod/addr_ok/{i}").decode() for i in range(n)]
    if any(found):
        raise ValueError("the pod's socket links cannot reach every process: "
                         + "; ".join(f for f in found if f) + " (give --coordinator a "
                         "name or address the other hosts reach this host at)")
    return n


def routed_address(host: str, port: int) -> str:
    """This host's address on the route to ``host`` (the coordinator):
    the local end of a UDP socket connected there, which sends nothing. A
    peer on another host reaches this process at it, where the hostname may
    resolve to a loopback alias."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host, port))
        return s.getsockname()[0]


def link_addresses(coordinator: str, routed: str, spans_hosts: bool) -> tuple[str, str]:
    """(the address this process's socket links listen at, the one it
    publishes to its peers). On one host both are ``routed``. Across hosts
    the links listen on every interface, and a process whose route to the
    coordinator is loopback (it runs on the coordinator's host, whose name
    may resolve to 127.0.1.1 there) publishes the coordinator's name or
    address as given: its peers reach this host by it, as they reached the
    pod's store."""
    if not spans_hosts:
        return routed, routed
    return "0.0.0.0", coordinator if _loopback(routed) else routed


def _loopback(addr: str) -> bool:
    return ipaddress.ip_address(addr).is_loopback


def _unreachable(addr: str) -> str:
    """Why a peer on another host cannot be reached at ``addr`` from this
    host ('' when it can): it resolves to a loopback address, or not at
    all."""
    try:
        resolved = socket.gethostbyname(addr)
    except OSError as e:
        return f"nothing ({e})"
    return f"loopback ({resolved})" if _loopback(resolved) else ""


def pod_transport() -> str:
    """The pod's data plane: ``"socket"`` (TCP links between the
    processes), or ``"shared"`` (CUDA IPC on the card, shared-memory files on
    the CPU) for processes of one host, and outside a pod."""
    return _JOINED.get("transport", "shared")


def pod_address() -> tuple[str, str]:
    """(listen, publish): where this process's socket links listen and
    the address its peers connect to (``link_addresses``)."""
    return _JOINED.get("listen", "127.0.0.1"), _JOINED.get("address", "127.0.0.1")


def peer_lost(detail: str) -> None:
    """A socket link of the pod failed (parallel/window.py,
    parallel/kvshare.py): a stream may wait on the card for a peer that is
    gone, where no host timeout reaches it, so the process ends with
    ``POD_LOST_EXIT_CODE``, as the pid watcher ends it, unless it is leaving
    the pod (given ``LEAVE_GRACE_S`` to find that out)."""
    if _LEAVING.wait(LEAVE_GRACE_S):
        return
    log_event("pod_peer_lost", detail=detail[:200])
    os._exit(POD_LOST_EXIT_CODE)


def _watch_peers(pids: dict) -> None:
    """End this process when a peer process of the host dies (the pod's
    peer-failure detection): a rank waiting in a ring step for a dead peer
    waits on the card, where no host timeout reaches it, and its host
    thread soon blocks behind it. ``leave_pod`` disarms it."""
    def run() -> None:
        while not _LEAVING.wait(PEER_CHECK_S):
            for index, pid in pids.items():
                if not alive(pid) and not _LEAVING.is_set():
                    log_event("pod_peer_lost", process=index, pid=pid)
                    os._exit(POD_LOST_EXIT_CODE)

    threading.Thread(target=run, name="pod-peers", daemon=True).start()


def leave_pod() -> None:
    """This process leaves the pod on purpose (the root stops its workers,
    a worker got OP_STOP): a peer's exit from here on is no failure."""
    _LEAVING.set()


def pod_store():
    """The pod's bootstrap store (``maybe_initialize_distributed``)."""
    if not _JOINED:
        raise RuntimeError("not in a pod: maybe_initialize_distributed found no coordinator")
    return _JOINED["store"]


def pod_hostnames() -> list:
    """Every process's hostname, as each published it to the store."""
    store = pod_store()
    return [store.get(f"pod/host/{i}").decode() for i in range(_JOINED["num_processes"])]


def agree(key: str, value: str) -> None:
    """Every process of the pod publishes ``value`` under ``key`` and reads
    every other's; raises ``ReplayError`` on every process when they
    differ (a startup skew, such as one process's paged KV layout against
    another's contiguous one, classified before any packet)."""
    store = pod_store()
    me, n = _JOINED["process_index"], _JOINED["num_processes"]
    store.set(f"{key}/{me}", value)
    values = {i: store.get(f"{key}/{i}").decode() for i in range(n)}
    if len(set(values.values())) > 1:
        raise ReplayError(f"the pod's processes disagree on {key}: "
                          + "; ".join(f"process {i}: {v}" for i, v in values.items())
                          + " (start every process with the same flags)")


class ControlPlane:
    """Fixed-size int32 packet, broadcast from process 0 each engine call.

    Layout: [magic, version, op, lane, n, start_pos, payload_a[L] ..
    payload_j[L]] with L = max(chunk, n_lanes, n_lanes * (SPEC_DRAFT + 1)):
    the JAX package's ``ControlPlane``, whose docstring gives each op's
    slots. Float arguments ride as their float32 bit patterns and seeds as
    uint32 bits, so the root's call and every replay get byte-identical
    values. ``recv`` validates magic and version before the op switch.
    ``fatal``: a failed broadcast ends the process (the root: its workers
    are gone and it cannot serve) instead of raising ``PodLost``."""

    HEADER = 6  # [magic, version, op, lane, n, start_pos]
    SLOTS = 10

    def __init__(self, n_lanes: int, chunk: int = 1024, fatal: bool = False):
        from ..runtime.spec import SPEC_DRAFT

        self.n_lanes = n_lanes
        # every slot fits its largest payload: prompt chunks (chunk),
        # per-lane vectors (n_lanes), the flattened in-chain drafts
        self.chunk = max(chunk, n_lanes, n_lanes * (SPEC_DRAFT + 1))
        self._size = self.HEADER + self.SLOTS * self.chunk
        self.fatal = fatal
        self.packets = 0
        self.bcast_s = 0.0

    def _check_spec_payload(self, flat: np.ndarray) -> np.ndarray:
        if len(flat) > self.chunk:
            raise ValueError(
                f"spec drafts payload {len(flat)} exceeds packet slot "
                f"{self.chunk}; size ControlPlane for the engine's draft layout"
            )
        return flat

    def _bcast(self, pkt: np.ndarray) -> np.ndarray:
        """The packet from process 0 to every process: one gloo broadcast
        of an int32 CPU tensor."""
        t = torch.from_numpy(np.ascontiguousarray(pkt, np.int32))
        t0 = time.perf_counter()
        try:
            torch.distributed.broadcast(t, src=0)
        except Exception as e:  # noqa: BLE001 — any transport failure is a lost pod
            log_event("pod_lost", error=f"{type(e).__name__}: {e}"[:200], fatal=self.fatal)
            if self.fatal:
                os._exit(POD_LOST_EXIT_CODE)
            raise PodLost(f"control packet broadcast failed: {e}") from e
        self.packets += 1
        self.bcast_s += time.perf_counter() - t0
        return t.numpy()

    def stats(self) -> dict:
        """Packets broadcast (or received) and the microseconds a broadcast
        took on average, on this process's clock."""
        return {"pod_packets": self.packets,
                "pod_broadcast_us": round(self.bcast_s / self.packets * 1e6, 1)
                if self.packets else None}

    def slot(self, pkt: np.ndarray, i: int, n: int) -> np.ndarray:
        start = self.HEADER + i * self.chunk
        return pkt[start: start + n]

    def _send(self, op: int, lane: int, n: int, start_pos: int, *payloads) -> None:
        faults.fire("plane.broadcast")  # the seeded fault plan; no-op unarmed
        pkt = np.zeros(self._size, np.int32)
        pkt[0:6] = (PACKET_MAGIC, PROTOCOL_VERSION, op, lane, n, start_pos)
        for i, payload in enumerate(payloads):
            if payload is not None:
                start = self.HEADER + i * self.chunk
                pkt[start: start + len(payload)] = payload
        self._bcast(pkt)

    @staticmethod
    def _f32(v) -> np.ndarray:
        return np.asarray(v, np.float32).view(np.int32)

    @staticmethod
    def _u32(v) -> np.ndarray:
        return np.asarray(v, np.uint32).view(np.int32)

    @staticmethod
    def _g(g_states):
        return None if g_states is None else np.asarray(g_states, np.int32)

    def send_prefill(self, lane: int, tokens, start_pos: int, temp: float = 0.0,
                     topp: float | None = None, seed: int = 0, g_state: int = 0) -> None:
        if topp is None:
            from ..runtime.engine import DEFAULT_TOPP as topp
        tbits = self._f32([temp])
        pbits = self._f32([topp])
        sbits = self._u32([seed & 0xFFFFFFFF])
        gbits = np.asarray([g_state], np.int32)
        for off in range(0, len(tokens), self.chunk):
            part = tokens[off: off + self.chunk]
            self._send(OP_PREFILL, lane, len(part), start_pos + off,
                       part, tbits, pbits, sbits, gbits)

    def send_decode(self, tokens, positions, temps=None, topps=None, seeds=None,
                    want_logits: bool = True, g_states=None) -> None:
        self._send(OP_DECODE, 1 if want_logits else 0, len(tokens), 0,
                   tokens, positions,
                   None if temps is None else self._f32(temps),
                   None if topps is None else self._f32(topps),
                   None if seeds is None else self._u32(seeds),
                   self._g(g_states))

    def send_decode_pipelined(self, tokens, positions, temps, topps, seeds, depth: int,
                              g_states=None) -> None:
        # feed flag rides `lane`, ring depth `start_pos`
        self._send(OP_DECODE_PIPELINED, 0 if tokens is None else 1, len(positions), depth,
                   tokens, positions, self._f32(temps), self._f32(topps), self._u32(seeds),
                   self._g(g_states))

    @staticmethod
    def _prefill_header(p_lane, p_start, chunk, p_temp, p_topp, p_seed, p_g) -> np.ndarray:
        """The 7-word fused-prefill header, one encoder for both fused ops."""
        phdr = np.zeros(7, np.int32)
        phdr[0:3] = (p_lane, p_start, len(chunk))
        phdr[3] = np.asarray([p_temp], np.float32).view(np.int32)[0]
        phdr[4] = np.asarray([p_topp], np.float32).view(np.int32)[0]
        phdr[5] = np.asarray([p_seed & 0xFFFFFFFF], np.uint32).view(np.int32)[0]
        phdr[6] = p_g
        return phdr

    def send_decode_prefill_fused(self, tokens, positions, temps, topps, seeds, depth: int,
                                  p_lane: int, chunk, p_start: int, p_temp: float,
                                  p_topp: float, p_seed: int, g_states=None,
                                  p_g: int = 0) -> None:
        # the DECODE_PIPELINED header; chunk slot 5, its header slot 6,
        # grammar states slot 7
        phdr = self._prefill_header(p_lane, p_start, chunk, p_temp, p_topp, p_seed, p_g)
        self._send(OP_DECODE_PREFILL_FUSED, 0 if tokens is None else 1, len(positions), depth,
                   tokens, positions, self._f32(temps), self._f32(topps), self._u32(seeds),
                   np.asarray(chunk, np.int32), phdr, self._g(g_states))

    def send_decode_spec_pipelined(self, tokens, positions, temps, topps, seeds, depth: int,
                                   drafts, draft_len, g_states=None) -> None:
        flat = self._check_spec_payload(np.asarray(drafts, np.int32).reshape(-1))
        # drafts + lengths slots 5/6, grammar states slot 7
        self._send(OP_DECODE_SPEC_PIPELINED, 0 if tokens is None else 1, len(positions),
                   depth, tokens, positions, self._f32(temps), self._f32(topps),
                   self._u32(seeds), flat, np.asarray(draft_len, np.int32),
                   self._g(g_states))

    def send_decode_spec_prefill_fused(self, tokens, positions, temps, topps, seeds,
                                       depth: int, drafts, draft_len, p_lane: int, chunk,
                                       p_start: int, p_temp: float, p_topp: float,
                                       p_seed: int, g_states=None, p_g: int = 0) -> None:
        flat = self._check_spec_payload(np.asarray(drafts, np.int32).reshape(-1))
        phdr = self._prefill_header(p_lane, p_start, chunk, p_temp, p_topp, p_seed, p_g)
        self._send(OP_DECODE_SPEC_PREFILL_FUSED, 0 if tokens is None else 1, len(positions),
                   depth, tokens, positions, self._f32(temps), self._f32(topps),
                   self._u32(seeds), flat, np.asarray(draft_len, np.int32),
                   np.asarray(chunk, np.int32), phdr, self._g(g_states))

    def send_decode_spec(self, tokens, drafts, draft_len, positions, temps, topps, seeds,
                         g_states=None) -> None:
        flat = self._check_spec_payload(np.asarray(drafts, np.int32).reshape(-1))
        self._send(OP_DECODE_SPEC, 0, len(tokens), 0,
                   tokens, positions, self._f32(temps), self._f32(topps), self._u32(seeds),
                   flat, np.asarray(draft_len, np.int32), self._g(g_states))

    def send_decode_multi(self, tokens, positions, temps, topps, seeds, h: int,
                          g_states=None) -> None:
        # the horizon rides the start_pos header field
        self._send(OP_DECODE_MULTI, 0, len(tokens), h,
                   tokens, positions, self._f32(temps), self._f32(topps), self._u32(seeds),
                   self._g(g_states))

    def _fragments(self, blob: bytes) -> list:
        """``blob`` in slot-sized fragments (an int32 word carries 4 bytes),
        each as (byte length, zero-padded words); one empty fragment for an
        empty blob."""
        frag_bytes = self.chunk * 4
        out = []
        for off in range(0, max(1, len(blob)), frag_bytes):
            frag = blob[off: off + frag_bytes]
            words = np.frombuffer(frag + b"\0" * ((-len(frag)) % 4), np.uint8).view(np.int32)
            out.append((len(frag), words))
        return out

    def send_grammar(self, blob: bytes, detach: bool = False) -> None:
        """A grammar attach (canonical response_format JSON) or detach (the
        schema key), in slot-sized fragments; workers act on the final one.
        Every process compiles locally: tables never cross the wire."""
        frags = self._fragments(blob)
        for idx, (nbytes, words) in enumerate(frags):
            flags = (1 if idx == len(frags) - 1 else 0) | (2 if detach else 0)
            self._send(OP_GRAMMAR, flags, nbytes, idx, words)

    def send_kv_table(self, lane: int, row, copies) -> None:
        """A paged table update: the row in slot 0 (its length in ``n``),
        the copy-on-write (src, dst) pairs flattened in slot 1 (their count
        in ``start_pos``); lane -1 unmaps every lane. Raises before the
        broadcast when the row or the pairs outgrow a slot."""
        row = np.asarray(row, np.int32)
        flat = np.asarray([c for pair in copies for c in pair], np.int32)
        if len(row) > self.chunk or len(flat) > self.chunk:
            raise ValueError(f"kv table payload (row {len(row)}, copies {len(flat)}) exceeds "
                             f"packet slot {self.chunk}; size ControlPlane(chunk=...) >= the "
                             "engine's blocks-per-lane")
        self._send(OP_KV_TABLE, lane, len(row), len(copies), row, flat)

    def send_kv_pages(self, pages) -> None:
        """Imported pages, each ``(page, payload)`` in slot-sized fragments:
        flags in ``lane`` (bit 0: the page's last fragment), the fragment's
        bytes in ``n``, the page in ``start_pos``. Raises before any
        broadcast on a negative page; the payload's size is the caller's
        check (``RootControlEngine.import_kv_page``)."""
        for page, payload in pages:
            if int(page) < 0:
                raise ValueError(f"kv page id must be >= 0, got {page}")
            frags = self._fragments(bytes(payload))
            for idx, (nbytes, words) in enumerate(frags):
                self._send(OP_KV_PAGES, 1 if idx == len(frags) - 1 else 0, nbytes, int(page),
                           words)

    def send_kv_swap(self, pages) -> None:
        """A host-tier swap-in batch, fragmented as ``send_kv_pages``, with
        bit 1 of the flags on the batch's last page's last fragment: the
        workers write the batch in one ``swap_in_pages`` call, as the root
        does. Raises before any broadcast on an empty batch or a negative
        page."""
        if not pages:
            raise ValueError("kv swap batch must not be empty")
        for p, _ in pages:
            if int(p) < 0:
                raise ValueError(f"kv page id must be >= 0, got {p}")
        for j, (page, payload) in enumerate(pages):
            frags = self._fragments(bytes(payload))
            for idx, (nbytes, words) in enumerate(frags):
                last = idx == len(frags) - 1
                flags = (1 if last else 0) | (2 if last and j == len(pages) - 1 else 0)
                self._send(OP_KV_SWAP, flags, nbytes, int(page), words)

    def send_pipeline_flush(self) -> None:
        self._send(OP_PIPELINE_FLUSH, 0, 0, 0)

    def send_stop(self) -> None:
        self._send(OP_STOP, 0, 0, 0)

    def send_stats_reset(self) -> None:
        self._send(OP_STATS_RESET, 0, 0, 0)

    def send_copy_lane(self, src: int, dst: int) -> None:
        # header fields carry the operands: lane=src, start_pos=dst
        self._send(OP_COPY_LANE, src, 0, dst)

    def recv(self) -> np.ndarray:
        faults.fire("plane.recv")  # the seeded fault plan; no-op unarmed
        pkt = self._bcast(np.zeros(self._size, np.int32))
        self.validate(pkt)
        return pkt

    @staticmethod
    def validate(pkt: np.ndarray) -> None:
        """Packet integrity gate, run on every recv before the op switch."""
        if len(pkt) < ControlPlane.HEADER:
            raise ReplayError(f"control packet truncated: {len(pkt)} words < header "
                              f"{ControlPlane.HEADER}")
        if int(pkt[0]) != PACKET_MAGIC:
            raise ReplayError(
                f"control packet magic mismatch: got 0x{int(pkt[0]) & 0xFFFFFFFF:08X}, "
                f"want 0x{PACKET_MAGIC:08X} (torn packet, or a peer that is not a "
                "dllama control plane)")
        if int(pkt[1]) != PROTOCOL_VERSION:
            raise ReplayError(
                f"control packet protocol version {int(pkt[1])} != {PROTOCOL_VERSION}: "
                "root and worker binaries are skewed (finish the rolling restart "
                "before serving)")


class RootControlEngine:
    """Engine proxy for process 0: validates, broadcasts the control packet,
    then makes the identical engine call the workers replay (the reference
    root's writeAll-then-forward, src/app.cpp:198-209). Attributes it does
    not define (stats, config, consume, lane_logits, ...) are the engine's:
    host-only calls that dispatch no ring step."""

    def __init__(self, engine, plane: ControlPlane):
        self._engine = engine
        self._plane = plane
        self._pod_step: dict = {}  # measure_pod_step's

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def grammar_attach(self, rf: dict):
        """Compile and install root-side first (a schema that cannot compile
        dies with zero packets out), then broadcast the canonical JSON in
        declaration order, so that every worker compiles the same automaton
        at the same slab base."""
        from ..grammar.automaton import validate_response_format

        canon = validate_response_format(rf)
        handle = self._engine.grammar_attach(rf)
        self._plane.send_grammar(json.dumps(canon).encode())
        return handle

    def grammar_detach(self, key: str) -> None:
        self._engine.grammar_detach(key)
        self._plane.send_grammar(str(key).encode(), detach=True)

    def prefill_chunk(self, lane: int, chunk, start_pos: int, temp: float = 0.0,
                      topp: float | None = None, seed: int = 0, g_state: int = 0):
        if topp is None:  # byte-identical default on packet and root call
            from ..runtime.engine import DEFAULT_TOPP as topp
        # validate before broadcasting: a chunk over the plane or the
        # engine's bucket would raise after the packet went out
        limit = min(self._plane.chunk, self._engine.max_chunk())
        if not 1 <= len(chunk) <= limit:
            raise ValueError(
                f"prefill chunk of {len(chunk)} outside [1, {limit}] (plane packet capacity "
                f"{self._plane.chunk}, engine bucket {self._engine.max_chunk()}); size "
                "ControlPlane(chunk=...) >= engine.max_chunk()")
        self._plane.send_prefill(lane, list(chunk), start_pos, temp, topp, seed,
                                 g_state=g_state)
        return self._engine.prefill_chunk(lane, list(chunk), start_pos, temp=temp, topp=topp,
                                          seed=seed, g_state=g_state)

    def prefill(self, lane: int, tokens, start_pos: int = 0, temp: float = 0.0,
                topp: float | None = None, seed: int = 0):
        if topp is None:
            from ..runtime.engine import DEFAULT_TOPP as topp
        # one packet, then its compute, per chunk: the workers replay each
        # packet with a blocking call, so broadcasting the whole prompt first
        # would deadlock on prompts over plane.chunk
        tokens = list(tokens)
        if not tokens:
            raise ValueError("prefill needs at least one token (empty prompt)")
        chunk = self._plane.chunk
        out = None
        for off in range(0, len(tokens), chunk):
            part = tokens[off: off + chunk]
            self._plane.send_prefill(lane, part, start_pos + off, temp, topp, seed)
            out = self._engine.prefill(lane, part, start_pos=start_pos + off, temp=temp,
                                       topp=topp, seed=seed)
        # the engine's (last logits, greedy, end position) of the last chunk
        return out

    def _normalize_sampling(self, temps, topps, seeds):
        """Packet and root-side call carry byte-identical sampling values."""
        from ..runtime.engine import DEFAULT_TOPP

        n = self._engine.n_lanes
        return (
            np.zeros(n, np.float32) if temps is None else np.asarray(temps, np.float32),
            np.full(n, DEFAULT_TOPP, np.float32) if topps is None
            else np.asarray(topps, np.float32),
            np.zeros(n, np.uint32) if seeds is None else np.asarray(seeds, np.uint32),
        )

    def _check_lane_vectors(self, *vecs) -> None:
        """Pre-broadcast shape validation of the plain decode-family ops'
        per-lane vectors (the pod-deadlock rule)."""
        n = self._engine.n_lanes
        for v in vecs:
            if v is not None and len(v) != n:
                raise ValueError(f"per-lane packet vector of length {len(v)} != n_lanes {n}: "
                                 "decode-family packets carry exactly one entry per lane")

    def decode(self, tokens, positions, temps=None, topps=None, seeds=None,
               want_logits: bool = True, g_states=None):
        temps, topps, seeds = self._normalize_sampling(temps, topps, seeds)
        self._check_lane_vectors(tokens, positions, temps, topps, seeds, g_states)
        self._plane.send_decode(np.asarray(tokens, np.int32), np.asarray(positions, np.int32),
                                temps, topps, seeds, want_logits=want_logits,
                                g_states=g_states)
        return self._engine.decode(tokens, positions, temps, topps, seeds,
                                   want_logits=want_logits, g_states=g_states)

    def decode_pipelined(self, positions, temps=None, topps=None, seeds=None, tokens=None,
                         g_states=None):
        """The packet first, then the root's half of the async chain;
        consume is host-only and forwards through __getattr__."""
        self._engine.check_pipelined_dispatch(tokens is not None, positions, g_states)
        # the default grammar vector, materialized now: packet and root
        # call carry the same values
        g_states = self._engine._g_vec(g_states, tokens is not None)
        temps, topps, seeds = self._normalize_sampling(temps, topps, seeds)
        self._plane.send_decode_pipelined(
            None if tokens is None else np.asarray(tokens, np.int32),
            np.asarray(positions, np.int32), temps, topps, seeds,
            depth=getattr(self._engine, "pipeline_depth", 2), g_states=g_states)
        return self._engine.decode_pipelined(positions, temps, topps, seeds, tokens=tokens,
                                             g_states=g_states)

    def _check_fused_chunk(self, chunk, p_topp):
        """One copy of the fused admissions' chunk validation and topp
        default; returns the resolved p_topp."""
        if p_topp is None:
            from ..runtime.engine import DEFAULT_TOPP as p_topp
        limit = min(self._plane.chunk, self._engine.max_chunk())
        if chunk is None or not 1 <= len(chunk) <= limit:
            raise ValueError(
                f"fused prefill chunk of {0 if chunk is None else len(chunk)} outside "
                f"[1, {limit}] (plane packet capacity {self._plane.chunk}, engine bucket "
                f"{self._engine.max_chunk()})")
        return p_topp

    def decode_prefill_fused(self, positions, temps=None, topps=None, seeds=None,
                             p_lane: int = 0, chunk=None, p_start: int = 0,
                             p_temp: float = 0.0, p_topp: float | None = None,
                             p_seed: int = 0, tokens=None, g_states=None, p_g: int = 0):
        """A stall-free admission on a pod: the engine's whole validation
        set before the packet, then the packet, then the root's half."""
        p_topp = self._check_fused_chunk(chunk, p_topp)
        self._engine.check_fused_dispatch(list(chunk), p_start, tokens is not None, positions,
                                          g_states)
        g_states = self._engine._g_vec(g_states, tokens is not None)
        temps, topps, seeds = self._normalize_sampling(temps, topps, seeds)
        self._plane.send_decode_prefill_fused(
            None if tokens is None else np.asarray(tokens, np.int32),
            np.asarray(positions, np.int32), temps, topps, seeds,
            depth=getattr(self._engine, "pipeline_depth", 2), p_lane=p_lane,
            chunk=list(chunk), p_start=p_start, p_temp=p_temp, p_topp=p_topp,
            p_seed=p_seed, g_states=g_states, p_g=p_g)
        return self._engine.decode_prefill_fused(
            positions, temps, topps, seeds, p_lane=p_lane, chunk=list(chunk), p_start=p_start,
            p_temp=p_temp, p_topp=p_topp, p_seed=p_seed, tokens=tokens, g_states=g_states,
            p_g=p_g)

    def decode_spec_pipelined(self, positions, drafts, draft_len, temps=None, topps=None,
                              seeds=None, tokens=None, g_states=None):
        drafts = np.asarray(drafts, np.int32)
        self._engine.check_spec_pipelined_dispatch(drafts, tokens is not None, positions,
                                                   g_states)
        g_states = self._engine._g_vec(g_states, tokens is not None)
        temps, topps, seeds = self._normalize_sampling(temps, topps, seeds)
        self._plane.send_decode_spec_pipelined(
            None if tokens is None else np.asarray(tokens, np.int32),
            np.asarray(positions, np.int32), temps, topps, seeds,
            depth=getattr(self._engine, "pipeline_depth", 2), drafts=drafts,
            draft_len=np.asarray(draft_len, np.int32), g_states=g_states)
        return self._engine.decode_spec_pipelined(positions, drafts, draft_len, temps, topps,
                                                  seeds, tokens=tokens, g_states=g_states)

    def decode_spec_prefill_fused(self, positions, drafts, draft_len, temps=None, topps=None,
                                  seeds=None, p_lane: int = 0, chunk=None, p_start: int = 0,
                                  p_temp: float = 0.0, p_topp: float | None = None,
                                  p_seed: int = 0, tokens=None, g_states=None, p_g: int = 0):
        p_topp = self._check_fused_chunk(chunk, p_topp)
        drafts = np.asarray(drafts, np.int32)
        self._engine.check_spec_drafts(drafts)
        self._engine.check_fused_dispatch(list(chunk), p_start, tokens is not None, positions,
                                          g_states)
        g_states = self._engine._g_vec(g_states, tokens is not None)
        temps, topps, seeds = self._normalize_sampling(temps, topps, seeds)
        self._plane.send_decode_spec_prefill_fused(
            None if tokens is None else np.asarray(tokens, np.int32),
            np.asarray(positions, np.int32), temps, topps, seeds,
            depth=getattr(self._engine, "pipeline_depth", 2), drafts=drafts,
            draft_len=np.asarray(draft_len, np.int32), p_lane=p_lane, chunk=list(chunk),
            p_start=p_start, p_temp=p_temp, p_topp=p_topp, p_seed=p_seed,
            g_states=g_states, p_g=p_g)
        return self._engine.decode_spec_prefill_fused(
            positions, drafts, draft_len, temps, topps, seeds, p_lane=p_lane,
            chunk=list(chunk), p_start=p_start, p_temp=p_temp, p_topp=p_topp, p_seed=p_seed,
            tokens=tokens, g_states=g_states, p_g=p_g)

    def pipeline_flush(self) -> int:
        """The chain's end or abort: the workers drain and drop their rings
        too (a flush replays no ring step; the packet is its only
        exchange)."""
        self._plane.send_pipeline_flush()
        return self._engine.pipeline_flush()

    def pipeline_abort(self) -> int:
        """Containment on a pod root: the workers drop their rings and
        carries (the flush packet), the root aborts without reading back."""
        self._plane.send_pipeline_flush()
        return self._engine.pipeline_abort()

    def decode_spec(self, tokens, drafts, draft_len, positions, temps=None, topps=None,
                    seeds=None, want_logits: bool = True, g_states=None):
        """The synchronous verify step. ``want_logits`` stays on the root
        (the JAX packet has no field for it): a worker's step keeps its
        logits, which nothing reads, and computes the same tokens."""
        temps, topps, seeds = self._normalize_sampling(temps, topps, seeds)
        self._check_lane_vectors(tokens, positions, temps, topps, seeds, drafts, draft_len,
                                 g_states)
        self._plane.send_decode_spec(
            np.asarray(tokens, np.int32), np.asarray(drafts, np.int32),
            np.asarray(draft_len, np.int32), np.asarray(positions, np.int32),
            temps, topps, seeds, g_states=g_states)
        return self._engine.decode_spec(tokens, drafts, draft_len, positions, temps, topps,
                                        seeds, want_logits=want_logits, g_states=g_states)

    def decode_multi(self, tokens, positions, temps=None, topps=None, seeds=None, h: int = 8,
                     g_states=None):
        temps, topps, seeds = self._normalize_sampling(temps, topps, seeds)
        self._check_lane_vectors(tokens, positions, temps, topps, seeds, g_states)
        if h < 1:
            raise ValueError(f"decode_multi horizon h={h} must be >= 1")
        self._plane.send_decode_multi(np.asarray(tokens, np.int32),
                                      np.asarray(positions, np.int32), temps, topps, seeds,
                                      h, g_states=g_states)
        return self._engine.decode_multi(tokens, positions, temps, topps, seeds, h,
                                         g_states=g_states)

    def measured_sync_stats(self, steps: int = 4) -> dict:
        """Off on a pod root: the probe's direct decode calls would not be
        broadcast, and the workers would never take their half of its ring
        steps. ``measure_pod_step`` is the pod's probe."""
        del steps
        return {}

    def measure_pod_step(self, steps: int = 8) -> None:
        """The pod's eager decode step, timed once at startup (the end of
        ``warmup_engine``, before either side's counters are reset) through
        the proxy, so that every worker replays it: the wall ms a step
        (``parked_step_ms``) and the ms this process's streams waited in the
        ring steps' waits, with its share; ``pod_stats`` reports them."""
        from ..runtime.engine import parked_step_ms

        pod = self._engine.pod
        step_ms = parked_step_ms(self, steps, timer=pod)
        wait_ms = pod.stop_timing() / steps
        self._pod_step = {"pod_step_ms": step_ms, "pod_step_wait_ms": wait_ms,
                          "pod_step_wait_share": wait_ms / step_ms}

    def pod_stats(self) -> dict:
        """The control plane's packets and broadcast time, beside the
        engine's window counters and the startup step's time."""
        return {**self._plane.stats(), **self._engine.pod_stats(), **self._pod_step}

    def stop_workers(self) -> None:
        leave_pod()
        self._plane.send_stop()
        self._engine.release_pod()

    def reset_worker_stats(self) -> None:
        """Workers drop warmup traffic from their counters too."""
        self._plane.send_stats_reset()

    def copy_lane(self, src: int, dst: int, prefix_len: int | None = None) -> None:
        """Prefix caching on a pod: every process copies its own ranks'
        caches, so the operands ride a packet before the root's copy."""
        if getattr(self._engine, "kvpool", None) is not None:
            raise RuntimeError("copy_lane is the contiguous layout's primitive; a paged "
                               "engine shares prefix pages by refcount via paged_admit")
        if src == dst or prefix_len == 0:
            return  # the engine's own short-circuit, before any packet
        n = self._engine.n_lanes
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"copy_lane {src} -> {dst} outside lane range [0, {n})")
        self._plane.send_copy_lane(src, dst)
        self._engine.copy_lane(src, dst)

    # -- the paged KV pool: host bookkeeping on the root, device halves on
    # every process. The pool, the page export and the swap-outs stay the
    # engine's (through __getattr__): host state, or reads that no worker
    # takes part in.

    def _need_paged(self, what: str):
        pool = getattr(self._engine, "kvpool", None)
        if pool is None:
            raise RuntimeError(f"{what} needs a paged engine")
        return pool

    def _check_pages(self, what: str, pages, payloads) -> None:
        """Pre-broadcast: each page in the pool, each payload one whole page
        (the engine's own size check, a ``ValueError``)."""
        pool = self._need_paged(what)
        for p in pages:
            if not 0 <= int(p) < pool.n_pages:
                raise ValueError(f"{what}: page {p} outside the pool's {pool.n_pages} pages")
        self._engine._check_payloads(payloads)

    def apply_paged_admit(self, lane: int, row, copies) -> None:
        """The device half of a paged admission or release on every
        process: the row and its copy-on-write pairs ride OP_KV_TABLE, then
        the root applies them. Lane, row width and pages are checked
        first."""
        pool = self._need_paged("apply_paged_admit")
        n = self._engine.n_lanes
        if not 0 <= lane < n:
            raise ValueError(f"apply_paged_admit: lane {lane} outside [0, {n})")
        if len(row) != pool.blocks_per_lane:
            raise ValueError(f"apply_paged_admit: a row of {len(row)} entries, the pool's "
                             f"{pool.blocks_per_lane} blocks a lane")
        for pair in copies:
            if any(not 0 <= int(p) < pool.n_pages for p in pair):
                raise ValueError(f"apply_paged_admit: copy {tuple(pair)} outside the pool's "
                                 f"{pool.n_pages} pages")
        self._plane.send_kv_table(lane, row, copies)
        self._engine.apply_paged_admit(lane, row, copies)

    def paged_admit(self, lane: int, tokens, reserve_tokens: int, min_share_tokens: int = 1,
                    share_quantum: int = 1) -> int:
        """A paged admission on a pod, in the engine's order: the pool's
        bookkeeping on the root before any packet (an admission that
        ``PoolExhausted`` sheds sends none), the staged swap-outs drained
        (a read of whole pages, the peers' heads from their planes: no
        packet), the host-tier hits as one OP_KV_SWAP batch, then the table
        row and its copies."""
        pool = self._need_paged("paged_admit")
        start, blocks, copies, swapins = pool.admit(
            lane, list(tokens), reserve_tokens, min_share_tokens, share_quantum)
        self._engine.drain_kv_swapouts()
        if swapins:
            self.swap_in_pages([p for p, _ in swapins], [b for _, b in swapins])
        self.apply_paged_admit(lane, pool.table_row(blocks), copies)
        return start

    def paged_finish(self, lane: int, park: bool = True) -> None:
        """A paged release on a pod: the bookkeeping on the root, the
        overflow's swap-outs drained there, then the unmapped row on every
        process; no packet for a lane that mapped nothing (a shed
        admission), as the engine skips its own write."""
        pool = self._need_paged("paged_finish")
        held = pool.finish(lane, park=park)
        self._engine.drain_kv_swapouts()
        if held:
            self.apply_paged_admit(lane, pool.table_row([]), [])

    def paged_reset(self) -> None:
        """Containment on a pod: the root drops its pool's contents, then
        every process unmaps every lane (OP_KV_TABLE's lane -1)."""
        pool = self._need_paged("paged_reset")
        pool.reset()
        self._plane.send_kv_table(-1, [], [])
        self._engine.paged_unmap_all()

    def import_kv_page(self, page: int, payload: bytes) -> None:
        """A hand-off's page import on every process: the page and the
        payload's size checked, then OP_KV_PAGES carries the whole page and
        each process writes its own ranks' heads."""
        self._check_pages("import_kv_page", [page], [payload])
        self._plane.send_kv_pages([(int(page), payload)])
        self._engine.import_kv_page(page, payload)

    def swap_in_pages(self, pages, payloads) -> None:
        """A host-tier swap-in on every process: the count, pages and sizes
        checked, then the batch as OP_KV_SWAP fragments, which each worker
        writes in one ``swap_in_pages`` call as the root does here."""
        self._need_paged("swap_in_pages")
        if len(pages) != len(payloads):
            raise ValueError(f"swap_in_pages: {len(pages)} pages vs {len(payloads)} payloads")
        if not pages:
            return
        self._check_pages("swap_in_pages", pages, payloads)
        self._plane.send_kv_swap(list(zip(pages, payloads)))
        self._engine.swap_in_pages(pages, payloads)


def worker_loop(engine, plane: ControlPlane, on_replay=None) -> None:
    """Replay root-broadcast engine calls until OP_STOP (the reference's
    runWorkerApp poll loop, src/app.cpp:405-464): every process takes the
    same ring steps in the same order. ``on_replay`` (if given) runs after
    each replayed packet."""
    gram_buf = bytearray()  # OP_GRAMMAR fragment accumulator
    page_buf = bytearray()  # OP_KV_PAGES: the page's fragments so far
    swap_buf = bytearray()  # OP_KV_SWAP: the page's fragments so far
    swap_batch: list = []  # OP_KV_SWAP: the batch's whole pages so far
    while True:
        pkt = plane.recv()
        # header: [magic, version, op, lane, n, start_pos]; magic/version
        # already validated by plane.recv()
        op, lane, n, start_pos = (int(x) for x in pkt[2:6])
        if op == OP_STOP:
            leave_pod()
            return
        if op == OP_PREFILL:
            engine.prefill(
                lane, [int(t) for t in plane.slot(pkt, 0, n)], start_pos=start_pos,
                temp=float(plane.slot(pkt, 1, 1).view(np.float32)[0]),
                topp=float(plane.slot(pkt, 2, 1).view(np.float32)[0]),
                seed=int(plane.slot(pkt, 3, 1).view(np.uint32)[0]),
                g_state=int(plane.slot(pkt, 4, 1)[0]),
            )
        elif op == OP_DECODE:
            engine.decode(
                plane.slot(pkt, 0, n), plane.slot(pkt, 1, n),
                plane.slot(pkt, 2, n).view(np.float32), plane.slot(pkt, 3, n).view(np.float32),
                plane.slot(pkt, 4, n).view(np.uint32),
                want_logits=bool(lane), g_states=plane.slot(pkt, 5, n),
            )
        elif op in (OP_DECODE_PIPELINED, OP_DECODE_PREFILL_FUSED, OP_DECODE_SPEC_PIPELINED,
                    OP_DECODE_SPEC_PREFILL_FUSED):
            # feed flag in `lane`, ring depth in `start_pos`: the worker
            # mirrors the root's bounded lag, consuming (its own readback)
            # only when its ring would pass the bound, and drops the chain
            # when the root reseeds after a flush
            if lane:
                engine.pipeline_flush(count=False)
            elif engine.pipeline_inflight() >= max(1, start_pos):
                engine.pipeline_consume()
            _replay_pipelined(engine, plane, pkt, op, lane, n)
        elif op == OP_DECODE_SPEC:
            k = engine.SPEC_DRAFT
            engine.decode_spec(
                plane.slot(pkt, 0, n), plane.slot(pkt, 5, n * k).reshape(n, k),
                plane.slot(pkt, 6, n), plane.slot(pkt, 1, n),
                plane.slot(pkt, 2, n).view(np.float32), plane.slot(pkt, 3, n).view(np.float32),
                plane.slot(pkt, 4, n).view(np.uint32), g_states=plane.slot(pkt, 7, n),
            )
        elif op == OP_DECODE_MULTI:
            engine.decode_multi(
                plane.slot(pkt, 0, n), plane.slot(pkt, 1, n),
                plane.slot(pkt, 2, n).view(np.float32), plane.slot(pkt, 3, n).view(np.float32),
                plane.slot(pkt, 4, n).view(np.uint32),
                start_pos,  # the horizon rides start_pos
                g_states=plane.slot(pkt, 5, n),
            )
        elif op == OP_GRAMMAR:
            # schema-byte fragments accumulate; the final one attaches or
            # (bit 1) detaches. Compiling is deterministic, so this worker's
            # slab lands the automaton at the root's base
            frag = plane.slot(pkt, 0, (n + 3) // 4).view(np.uint8)[:n]
            gram_buf += frag.tobytes()
            if lane & 1:
                blob = bytes(gram_buf)
                gram_buf = bytearray()
                if lane & 2:
                    engine.grammar_detach(blob.decode())
                else:
                    engine.grammar_attach(json.loads(blob))
        elif op == OP_PIPELINE_FLUSH:
            # count=False: the worker's ring lags the root's by design, so
            # holding steps at a clean chain end is no abort
            engine.pipeline_flush(count=False)
        elif op == OP_STATS_RESET:
            # the root zeroes the same after its warmup (runtime_setup)
            engine.stats.reset()
            reset_kernel_counts()
            if getattr(engine, "pod", None) is not None:
                engine.pod.reset_stats()
        elif op == OP_COPY_LANE:
            engine.copy_lane(lane, start_pos)  # src, dst ride the header
        elif op in (OP_KV_TABLE, OP_KV_PAGES, OP_KV_SWAP):
            # each skew is classified before any dispatch: a contiguous
            # engine, a table width or a page size other than the root's
            if getattr(engine, "kvpool", None) is None:
                raise ReplayError(f"{_PAGED_OPS[op]} on a non-paged engine: root and worker "
                                  "--paged-kv flags are skewed")
            if op == OP_KV_TABLE:
                # row length in n, pair count in start_pos, lane -1 the reset
                if lane < 0:
                    engine.paged_unmap_all()
                else:
                    if n != engine.kvpool.blocks_per_lane:
                        raise ReplayError(
                            f"OP_KV_TABLE row of {n} entries vs this worker's "
                            f"{engine.kvpool.blocks_per_lane} blocks/lane: root and worker "
                            "paged-KV geometry flags are skewed")
                    pairs = plane.slot(pkt, 1, 2 * start_pos)
                    engine.apply_paged_admit(lane, plane.slot(pkt, 0, n).copy(),
                                             list(zip((int(p) for p in pairs[0::2]),
                                                      (int(p) for p in pairs[1::2]))))
            else:
                # fragments accumulate (one page's are contiguous in the
                # ordered stream); the page rides start_pos
                frag = plane.slot(pkt, 0, (n + 3) // 4).view(np.uint8)[:n].tobytes()
                try:
                    if op == OP_KV_PAGES:
                        page_buf += frag
                        if lane & 1:  # the page's last fragment
                            blob, page_buf = bytes(page_buf), bytearray()
                            engine.import_kv_page(start_pos, blob)
                    else:
                        swap_buf += frag
                        if lane & 1:
                            swap_batch.append((start_pos, bytes(swap_buf)))
                            swap_buf = bytearray()
                        if lane & 2:  # the batch's last page: one call, as the root's
                            batch, swap_batch = swap_batch, []
                            engine.swap_in_pages([p for p, _ in batch], [b for _, b in batch])
                except ValueError as e:
                    raise ReplayError(f"{_PAGED_OPS[op]} payload rejected: {e}; root and "
                                      "worker paged-KV geometry flags are skewed") from e
        else:
            # classified, pre-dispatch: worker_serve resubscribes without
            # burning a restart
            raise ReplayError(f"unknown control op {op}")
        if on_replay is not None:
            on_replay()


def _replay_pipelined(engine, plane: ControlPlane, pkt, op: int, lane: int, n: int) -> None:
    """The four in-ring ops' dispatch, after the ring's bounded-lag rule:
    the DECODE_PIPELINED slots, plus the chunk and its 7-word header
    (fused), the drafts and their lengths (spec), or all of them."""
    tokens = plane.slot(pkt, 0, n) if lane else None
    sampling = (plane.slot(pkt, 2, n).view(np.float32), plane.slot(pkt, 3, n).view(np.float32),
                plane.slot(pkt, 4, n).view(np.uint32))
    spec = op in (OP_DECODE_SPEC_PIPELINED, OP_DECODE_SPEC_PREFILL_FUSED)
    prompt = {}
    if op in (OP_DECODE_PREFILL_FUSED, OP_DECODE_SPEC_PREFILL_FUSED):
        chunk_slot = 7 if spec else 5
        phdr = plane.slot(pkt, chunk_slot + 1, 7)
        prompt = {"p_lane": int(phdr[0]),
                  "chunk": [int(t) for t in plane.slot(pkt, chunk_slot, int(phdr[2]))],
                  "p_start": int(phdr[1]),
                  "p_temp": float(phdr[3:4].view(np.float32)[0]),
                  "p_topp": float(phdr[4:5].view(np.float32)[0]),
                  "p_seed": int(phdr[5:6].view(np.uint32)[0]),
                  "p_g": int(phdr[6])}
    # the grammar states follow the op's last payload slot
    g_slot = {OP_DECODE_PIPELINED: 5, OP_DECODE_PREFILL_FUSED: 7,
              OP_DECODE_SPEC_PIPELINED: 7, OP_DECODE_SPEC_PREFILL_FUSED: 9}[op]
    g_states = plane.slot(pkt, g_slot, n)
    positions = plane.slot(pkt, 1, n)
    if spec:
        k1 = engine.SPEC_DRAFT + 1
        drafts = plane.slot(pkt, 5, n * k1).reshape(n, k1)
        draft_len = plane.slot(pkt, 6, n)
        if prompt:
            engine.decode_spec_prefill_fused(positions, drafts, draft_len, *sampling,
                                             tokens=tokens, g_states=g_states, **prompt)
        else:
            engine.decode_spec_pipelined(positions, drafts, draft_len, *sampling,
                                         tokens=tokens, g_states=g_states)
    elif prompt:
        engine.decode_prefill_fused(positions, *sampling, tokens=tokens, g_states=g_states,
                                    **prompt)
    else:
        engine.decode_pipelined(positions, *sampling, tokens=tokens, g_states=g_states)


def worker_serve(engine, plane: ControlPlane, max_restarts: int | None = 3,
                 healthy_window: int = 64, log=None) -> None:
    """Supervised worker: re-enter ``worker_loop`` after a replay error (the
    reference's outer loop, src/app.cpp:455-463), within a restart budget
    that ``healthy_window`` consecutive good replays refresh, so a
    persistent error (the desync signature) still ends the process.
    Classified ``ReplayError``\\ s burn no restart: they have their own,
    larger storm bound. A lost pod (``PodLost``, ``PodPeerLost``) is never
    retried. Every restart emits a structured log event
    (``worker_restart`` / ``worker_protocol_error``) and bumps
    ``engine.stats.worker_restarts`` / ``worker_replay_errors``; ``log``
    (optional) receives a one-line summary."""
    restarts = 0
    healthy = 0
    protocol_errors = 0
    protocol_budget = max(64, (max_restarts or 0) * 16)
    stats = getattr(engine, "stats", None)

    def _count(name: str) -> None:
        if stats is not None:
            with stats.lock:
                setattr(stats, name, getattr(stats, name) + 1)

    def _replayed() -> None:
        nonlocal restarts, healthy, protocol_errors
        healthy += 1
        if healthy >= healthy_window:
            restarts = 0
            protocol_errors = 0
            healthy = 0

    while True:
        try:
            worker_loop(engine, plane, on_replay=_replayed)
            return
        except (PodLost, PodPeerLost):
            raise
        except ReplayError as e:
            healthy = 0
            protocol_errors += 1
            _count("worker_replay_errors")
            log_event("worker_protocol_error", error=str(e)[:200],
                      protocol_errors=protocol_errors, protocol_budget=protocol_budget)
            if log is not None:
                log(f"worker protocol error ({protocol_errors}): {e}")
            if protocol_errors > protocol_budget:
                raise
        except Exception as e:  # noqa: BLE001 — the supervised restart boundary
            healthy = 0
            restarts += 1
            _count("worker_restarts")
            log_event("worker_restart", error=f"{type(e).__name__}: {e}"[:200],
                      restarts=restarts, max_restarts=max_restarts)
            if log is not None:
                log(f"worker replay error (restart {restarts}): {e!r}")
            if max_restarts is not None and restarts > max_restarts:
                raise

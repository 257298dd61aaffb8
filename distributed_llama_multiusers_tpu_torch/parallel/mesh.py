"""The port's device mesh: one device per rank, the JAX package's axes.

The JAX package runs its serving meshes under a single controller over a
``jax.sharding.Mesh`` with named axes (dp, pp, tp, sp, ep), its devices the
device list reshaped to (dp, pp, tp, sp, ep) row-major. The port keeps the
same plan, checks and order: rank r is the r-th device of that list, so the
same ``--device`` list puts the same coordinate on the same card. Its
``Mesh`` is the per-rank device list, the axis sizes, each rank's
coordinates and the rank groups the forward syncs over:

    tp group:     the ranks of one (dp, sp, ep) point, in tp order: the wo/w2
                  sync and the logits gather
    sp group:     the ranks of one (dp, tp, ep) point, in sp order: the
                  attention's flash stats (parallel/ring_attention.py)
    ep x tp group: the ranks of one (dp, sp) point, in rank order: an MoE
                  layer's routed partials

One process drives its ranks (models/llama.py). A device may repeat
(``cuda:0,cuda:0``): the ranks then share one card, the counterpart of the
JAX package's virtual devices on one host.

A pod (parallel/multihost.py) spreads the ranks over processes: the plan
stays global (``--workers`` names the global mesh, as in the JAX package)
and process i holds the contiguous block of ``ranks / num_processes`` ranks
starting at ``i * ranks / num_processes``, on the devices ``--device``
names. A pod splits tp ranks only: dp, sp and ep above 1 in a pod are later
work (ROADMAP A9.1), as is pp anywhere (ROADMAP A9.2, with the training
slice's pipeline).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.config import LlamaConfig

AXES = ("dp", "pp", "tp", "sp", "ep")


@dataclass(frozen=True)
class MeshPlan:
    dp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.sp * self.ep * self.pp


@dataclass(frozen=True)
class Mesh:
    """This process's ranks' devices (rank ``first + i`` on ``devices[i]``;
    every rank where the mesh is one process) and the global axis sizes."""

    devices: tuple
    shape: dict
    process_index: int = 0
    num_processes: int = 1

    @property
    def tp(self) -> int:
        """The tp width (ranks in a tp group), not the rank count."""
        return self.shape["tp"]

    @property
    def n_ranks(self) -> int:
        """Every rank of the mesh, in every process."""
        return math.prod(self.shape[ax] for ax in AXES)

    @property
    def pure_tp(self) -> bool:
        """No axis but tp above 1."""
        return all(self.shape[ax] == 1 for ax in AXES if ax != "tp")

    @property
    def local_ranks(self) -> range:
        """The global ranks this process holds, in order."""
        per = self.n_ranks // self.num_processes
        return range(self.process_index * per, (self.process_index + 1) * per)

    def coords(self, r: int) -> dict:
        """Rank r's coordinate on each axis: r's index in the device grid
        (dp, pp, tp, sp, ep), row-major, as the JAX package lays it out."""
        out = {}
        for ax in reversed(AXES):
            r, out[ax] = divmod(r, self.shape[ax])
        return {ax: out[ax] for ax in AXES}

    def rank(self, **coords) -> int:
        """The rank at ``coords`` (axes left out at 0)."""
        r = 0
        for ax in AXES:
            r = r * self.shape[ax] + coords.get(ax, 0)
        return r

    def _groups(self, varying: tuple) -> list:
        """The ranks that share every coordinate but ``varying``'s, one list
        a group, each in rank order; the groups ordered by their first
        rank."""
        groups: dict = {}
        for r in range(self.n_ranks):
            c = self.coords(r)
            groups.setdefault(tuple(c[ax] for ax in AXES if ax not in varying), []).append(r)
        return sorted(groups.values())

    def tp_groups(self) -> list:
        return self._groups(("tp",))

    def sp_groups(self) -> list:
        return self._groups(("sp",))

    def ep_tp_groups(self) -> list:
        return self._groups(("ep", "tp"))

    @property
    def is_pod(self) -> bool:
        return self.num_processes > 1


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass --device cpu to run on the CPU"
        )


def _cuda_devices(n: int) -> list:
    _require_cuda()
    if n > torch.cuda.device_count():
        raise ValueError(f"mesh plan needs {n} devices, have "
                         f"{torch.cuda.device_count()} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(plan: MeshPlan, devices=None, process_index: int = 0,
              num_processes: int = 1) -> Mesh:
    """A Mesh over ``devices`` (default ``cuda:0`` .. ``cuda:N-1``), the
    devices of this process's ranks in rank order: all of them, or in a pod
    of ``num_processes`` the ``ranks / num_processes`` ranks of process
    ``process_index``. Raises when there are fewer devices than the ranks it
    holds, for pp above 1, for a pod with any axis but tp above 1, and for a
    tp that the process count does not divide."""
    if plan.pp > 1:
        raise ValueError(
            f"pp={plan.pp}: the port serves dp, tp, sp and ep meshes; pipeline "
            "parallelism comes with the training slice's pipeline (ROADMAP A9.2)"
        )
    if num_processes < 1 or not 0 <= process_index < num_processes:
        raise ValueError(f"process {process_index} of {num_processes}")
    if num_processes > 1:
        others = {ax: getattr(plan, ax) for ax in ("dp", "sp", "ep") if getattr(plan, ax) > 1}
        if others:
            raise ValueError(
                f"a pod splits tp ranks only; {others} across processes is later work "
                "(ROADMAP A9.1: pods with dp, sp and ep axes)"
            )
    if plan.tp % num_processes:
        raise ValueError(f"tp={plan.tp} does not split over {num_processes} processes: "
                         "each process holds the same number of ranks")
    held = plan.n_devices // num_processes
    if devices is None:
        devices = _cuda_devices(held)
    if held > len(devices):
        raise ValueError(f"mesh plan needs {held} devices in this process, have {len(devices)}")
    devs = tuple(torch.device(d) for d in devices[:held])
    return Mesh(devices=devs, shape={ax: getattr(plan, ax) for ax in AXES},
                process_index=process_index, num_processes=num_processes)


def mesh_devices(spec: str, n: int) -> list:
    """The per-rank devices that ``--device`` names for ``n`` ranks: one
    device (``cpu``: every rank on the CPU; ``cuda``: ``cuda:0`` ..
    ``cuda:n-1``, distinct cards) or a comma list with one entry per rank. A
    card serves more than one rank only where the list names it each time
    (``cuda:0,cuda:0``)."""
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if len(parts) == 1 and n > 1:
        dev = torch.device(parts[0])
        if dev.type == "cpu":
            return [dev] * n
        if dev.type == "cuda" and dev.index is None:
            return _cuda_devices(n)
        raise ValueError(
            f"--device {spec} names one device for {n} ranks; list one device "
            f"per rank (e.g. {','.join([parts[0]] * n)})"
        )
    if len(parts) != n:
        raise ValueError(f"--device lists {len(parts)} devices for {n} ranks")
    devices = [torch.device(p) for p in parts]
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"--device {spec} mixes device types")
    for d in devices:
        if d.type == "cuda":
            _require_cuda()
            if d.index is None:
                raise ValueError(f"--device {spec}: name each card's index (cuda:0, ...)")
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"{d} does not exist ({torch.cuda.device_count()} CUDA devices)")
    return devices


def validate_mesh_for_config(config: LlamaConfig, plan: MeshPlan) -> None:
    """TP validity rules carried over from the reference (its app.cpp:237
    check and slicer asserts) plus SP divisibility."""
    tp, sp = plan.tp, plan.sp
    if tp > config.n_kv_heads:
        raise ValueError(f"tp={tp} exceeds n_kv_heads={config.n_kv_heads}")
    if config.n_kv_heads % tp != 0:
        raise ValueError(f"n_kv_heads={config.n_kv_heads} not divisible by tp={tp}")
    if config.n_heads % tp != 0:
        raise ValueError(f"n_heads={config.n_heads} not divisible by tp={tp}")
    if config.dim % tp != 0 or config.hidden_dim % tp != 0:
        raise ValueError("dim/hidden_dim not divisible by tp")
    if config.vocab_size % tp != 0:
        raise ValueError("vocab_size not divisible by tp")
    if config.seq_len % sp != 0:
        raise ValueError(f"seq_len={config.seq_len} not divisible by sp={sp}")
    if plan.pp > 1 and config.n_layers % plan.pp != 0:
        raise ValueError(f"n_layers={config.n_layers} not divisible by pp={plan.pp}")
    if plan.ep > 1:
        if config.n_experts <= 0:
            raise ValueError(f"ep={plan.ep} needs an MoE model (n_experts > 0)")
        if config.n_experts % plan.ep != 0:
            raise ValueError(
                f"n_experts={config.n_experts} not divisible by ep={plan.ep}"
            )

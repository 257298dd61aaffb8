"""The port's device mesh: one device per tensor-parallel rank.

The JAX package runs TP under a single controller over a ``jax.sharding.Mesh``
with named axes (dp, pp, tp, sp, ep). The port keeps the same plan and
checks, and its ``Mesh`` is the per-rank device list plus the axis sizes:
one process drives every rank, layer by layer (models/llama.py). A device
may repeat (``cuda:0,cuda:0``): the ranks then share one card, the
counterpart of the JAX package's virtual devices on one host. This slice
serves pure TP; dp, sp, ep and pp meshes are later work (ROADMAP A7/A8).
"""

from __future__ import annotations

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
    """Per-rank devices (rank r on ``devices[r]``) and the axis sizes."""

    devices: tuple
    shape: dict

    @property
    def tp(self) -> int:
        return self.shape["tp"]


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


def make_mesh(plan: MeshPlan, devices=None) -> Mesh:
    """A Mesh over ``devices`` (default ``cuda:0`` .. ``cuda:N-1``). Raises
    when there are fewer devices than the plan needs, and for any axis but
    tp above 1."""
    others = {ax: getattr(plan, ax) for ax in ("dp", "sp", "ep", "pp") if getattr(plan, ax) > 1}
    if others:
        raise ValueError(
            f"the PyTorch port serves pure tensor parallelism; {others} is later "
            "work (ROADMAP A7: multi-process TP, A8: sequence and pipeline "
            "parallelism)"
        )
    if devices is None:
        devices = _cuda_devices(plan.n_devices)
    if plan.n_devices > len(devices):
        raise ValueError(f"mesh plan needs {plan.n_devices} devices, have {len(devices)}")
    devs = tuple(torch.device(d) for d in devices[: plan.n_devices])
    return Mesh(devices=devs, shape={ax: getattr(plan, ax) for ax in AXES})


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

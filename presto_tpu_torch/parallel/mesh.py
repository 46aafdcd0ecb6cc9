"""The mesh of logical workers.

Counterpart of ``presto_tpu/parallel/mesh.py``. The reference's workers are
the devices of a ``jax.sharding.Mesh`` (its tests run 8 virtual XLA host
devices in one process). Here a mesh is a list of per-worker
``torch.device``s, which may repeat: four logical workers on one H100 are
``MeshContext([torch.device("cuda", 0)] * 4)``, and the tests run two or
eight CPU workers. A collective (``parallel/exchange.py``) is a plain
PyTorch op over the per-worker tensors in one process; each result lands on
its worker's device. There is no ``torch.distributed`` and no NCCL here: a
card is one device, and NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch


@dataclasses.dataclass
class WorkerNode:
    """A schedulable worker: one logical worker of the mesh."""
    node_id: str
    device: torch.device
    index: int

    @property
    def is_coordinator(self) -> bool:
        return self.index == 0


class MeshContext:
    """The engine's workers and their devices. ``devices`` defaults to one
    worker per visible CUDA device (the reference's one per jax device) and
    raises without CUDA; ``n_workers`` keeps the first that many."""

    def __init__(self, devices: Optional[Sequence] = None, n_workers: Optional[int] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: pass the mesh's devices, e.g. "
                    "MeshContext([torch.device('cpu')] * 2)")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devs = [torch.device(d) for d in devices]
        if n_workers is not None:
            devs = devs[:n_workers]
        if not devs:
            raise ValueError("a mesh needs at least one worker")
        self.devices: List[torch.device] = devs
        self.nodes = [WorkerNode(f"worker-{i}", d, i) for i, d in enumerate(devs)]

    @property
    def n_workers(self) -> int:
        return len(self.devices)

    def sharded(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A global array split evenly over the workers, shard w on worker
        w's device (the reference's ``P(WORKER_AXIS)`` placement)."""
        W = self.n_workers
        if x.shape[0] % W:
            raise ValueError(f"{x.shape[0]} rows do not split over {W} workers")
        return [s.to(d) for s, d in zip(torch.chunk(x, W), self.devices)]

    def replicated(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One copy of ``x`` per worker, on its device (``P()``)."""
        return [x.to(d) for d in self.devices]

    def active_nodes(self) -> List[WorkerNode]:
        return self.nodes

    def __repr__(self) -> str:
        return f"MeshContext({[str(d) for d in self.devices]})"


_default_mesh: Optional[MeshContext] = None


def default_mesh() -> MeshContext:
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = MeshContext()
    return _default_mesh


def set_default_mesh(ctx: MeshContext) -> None:
    global _default_mesh
    _default_mesh = ctx

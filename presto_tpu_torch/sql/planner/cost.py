"""Cost model: cpu / memory / network terms over row estimates.

The PyTorch port's copy of ``presto_tpu/sql/planner/cost.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of the reference CBO's cost side — cost/CostCalculatorUsingExchanges
.java:66 (exchange network terms), cost/LocalCostEstimate (cpu/memory per
operator) — narrowed to the decisions this engine makes from cost:

  * join ORDER (optimizer.reorder_joins asks for the cheapest next join)
  * join DISTRIBUTION (add_exchanges compares broadcast vs repartition
    network+memory, the DetermineJoinDistributionType analogue)

Row estimates come from optimizer.estimate_rows (connector row counts +
fixed selectivities — the StatsCalculator stand-in). Costs are unit-weight
abstract numbers: 1 cpu = one row touched, 1 memory = one build row held
device-resident, 1 network = one row crossing the exchange. TPU framing:
memory is HBM (the scarcest resource — build sides must fit), network is
ICI hops (cheap inside a slice but not free), cpu is VPU/MXU row work.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PlanCost:
    cpu: float = 0.0
    memory: float = 0.0
    network: float = 0.0

    def plus(self, other: "PlanCost") -> "PlanCost":
        return PlanCost(self.cpu + other.cpu,
                        self.memory + other.memory,
                        self.network + other.network)

    def total(self, cpu_w: float = 1.0, mem_w: float = 2.0,
              net_w: float = 2.0) -> float:
        """Scalarization for comparisons. Memory and network weigh heavier
        than cpu: HBM residency and ICI traffic are the scaling walls."""
        return cpu_w * self.cpu + mem_w * self.memory + net_w * self.network

    def __repr__(self):
        return (f"PlanCost(cpu={self.cpu:.3g}, mem={self.memory:.3g}, "
                f"net={self.network:.3g})")


ZERO = PlanCost()


def join_step_cost(probe_rows: float, build_rows: float,
                   output_rows: float) -> PlanCost:
    """One hash-join step: build the table (cpu+memory), stream the probe,
    emit the output (LocalCostEstimate for HashBuilder+LookupJoin)."""
    return PlanCost(cpu=probe_rows + build_rows + output_rows,
                    memory=build_rows,
                    network=0.0)


def broadcast_cost(build_rows: float, n_workers: int) -> PlanCost:
    """Replicate the build side to every worker: network scales with W, and
    every worker holds a full copy in HBM."""
    return PlanCost(cpu=0.0,
                    memory=build_rows * n_workers,
                    network=build_rows * max(n_workers - 1, 1))


def repartition_cost(probe_rows: float, build_rows: float) -> PlanCost:
    """Hash-repartition BOTH sides: every row crosses the mesh once; each
    worker holds build/W rows (counted as build total across the mesh)."""
    return PlanCost(cpu=0.0,
                    memory=build_rows,
                    network=probe_rows + build_rows)


def cheaper_to_broadcast(probe_rows: float, build_rows: float,
                         n_workers: int,
                         broadcast_memory_limit_rows: float) -> bool:
    """DetermineJoinDistributionType.java's AUTOMATIC decision by cost:
    replicate small builds (saves repartitioning the big probe) unless the
    replicated table would blow the per-worker HBM budget."""
    if build_rows > broadcast_memory_limit_rows:
        return False
    bc = broadcast_cost(build_rows, n_workers)
    rp = repartition_cost(probe_rows, build_rows)
    return bc.total() < rp.total()

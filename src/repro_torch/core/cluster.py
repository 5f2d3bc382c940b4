"""Cluster-level data model: multiple pipelines sharing one core pool.

The paper plans each pipeline in isolation; its §6 discussion (and the
cluster-level arbitration in INFaaS / InferLine) points at the production
setting this module models: N linear pipelines contending for a single
budget of ``cores`` (the paper's cost unit — CPU cores), where cost
arbitration happens *across* pipelines.

``ClusterModel`` is the static description (which pipelines, how many
cores total); ``ClusterConfig`` is one joint configuration (one
``PipelineConfig`` per pipeline) with a total-cost accessor and a budget
check.  The single-pipeline stack is the N=1 special case throughout:
``ClusterSimulator`` (core.simulator) runs every pipeline's stages in one
event heap, and ``solve_cluster`` (core.optimizer) arbitrates per-pipeline
Pareto frontiers under ``sum(cost) <= cores``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.core.pipeline import PipelineConfig, PipelineModel

_COST_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """N pipelines plus the shared core budget C they contend for.

    ``cores`` may be a plain scalar (the legacy single fungible pool) or a
    mapping of device-class budgets, e.g. ``{"cpu": 512, "gpu": 16}`` —
    INFaaS-style heterogeneous pools.  A mapping is normalized into
    ``class_budgets`` (sorted ``(class, budget)`` tuples, part of the
    model's identity) and ``cores`` becomes the scalar total, so every
    legacy total-budget reader keeps working; ``is_hetero`` gates all
    per-class arbitration/ledger paths, which a scalar-budget cluster
    never enters.

    ``sla_weights`` (INFaaS-style workload importance): per-pipeline
    multipliers on the arbitration objective — a pipeline with weight 2
    counts double in the joint knapsack, so under contention its accuracy
    is sacrificed last.  ``None`` means every pipeline weighs 1.0.
    """
    name: str
    pipelines: Tuple[PipelineModel, ...]
    cores: float = float("inf")          # shared budget C (inf = unbounded)
    sla_weights: Optional[Tuple[float, ...]] = None
    class_budgets: Optional[Tuple[Tuple[str, float], ...]] = None

    def __post_init__(self):
        if not self.pipelines:
            raise ValueError("a cluster needs at least one pipeline")
        if isinstance(self.cores, Mapping):
            if self.class_budgets is not None:
                raise ValueError(
                    "pass per-class budgets via cores OR class_budgets")
            object.__setattr__(self, "class_budgets",
                               tuple(self.cores.items()))
            object.__setattr__(self, "cores", None)
        if self.class_budgets is not None:
            cb = tuple(sorted((str(c), float(b))
                              for c, b in self.class_budgets))
            if not cb:
                raise ValueError("per-class budgets must name >= 1 class")
            if len({c for c, _ in cb}) != len(cb):
                raise ValueError("duplicate device class in budgets")
            if any(b < 0 for _, b in cb):
                raise ValueError("per-class budgets must be >= 0")
            object.__setattr__(self, "class_budgets", cb)
            object.__setattr__(self, "cores",
                               float(sum(b for _, b in cb)))
            classes = {c for c, _ in cb}
            for pipe in self.pipelines:
                for st in pipe.stages:
                    for v in st.variants:
                        missing = set(v.device_classes) - classes
                        if missing:
                            raise ValueError(
                                f"variant {v.name} targets device classes "
                                f"{sorted(missing)} with no budget")
        if self.sla_weights is not None:
            if len(self.sla_weights) != len(self.pipelines):
                raise ValueError("one SLA weight per pipeline required")
            if any(w <= 0 for w in self.sla_weights):
                raise ValueError("SLA weights must be positive")

    @property
    def is_hetero(self) -> bool:
        """True when the budget is per-device-class (vector paths gated
        here; a scalar-budget cluster never enters them)."""
        return self.class_budgets is not None

    @property
    def device_classes(self) -> Tuple[str, ...]:
        """Budgeted device classes, sorted (``("cpu",)`` for a scalar
        budget) — the canonical axis order of every cost vector."""
        if self.class_budgets is None:
            return ("cpu",)
        return tuple(c for c, _ in self.class_budgets)

    @property
    def budget_vector(self) -> Tuple[float, ...]:
        """Per-class budgets aligned with ``device_classes`` (a scalar
        budget is the single-class vector ``(cores,)``)."""
        if self.class_budgets is None:
            return (float(self.cores),)
        return tuple(b for _, b in self.class_budgets)

    @property
    def n_pipelines(self) -> int:
        return len(self.pipelines)

    @property
    def weights(self) -> Tuple[float, ...]:
        """Effective per-pipeline SLA weights (1.0 when unset)."""
        if self.sla_weights is None:
            return tuple(1.0 for _ in self.pipelines)
        return tuple(float(w) for w in self.sla_weights)

    def pipeline(self, name: str) -> PipelineModel:
        for p in self.pipelines:
            if p.name == name:
                return p
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """One joint configuration: a PipelineConfig per pipeline, in order."""
    pipelines: Tuple[PipelineConfig, ...]

    def cost(self, cluster: ClusterModel) -> float:
        """Total cores allocated across every pipeline's stages."""
        if len(self.pipelines) != len(cluster.pipelines):
            raise ValueError("config/cluster pipeline count mismatch")
        return float(sum(cfg.cost(pipe) for cfg, pipe
                         in zip(self.pipelines, cluster.pipelines)))

    def cost_by_class(self, cluster: ClusterModel) -> Tuple[float, ...]:
        """Total per-device-class cost vector, aligned with
        ``cluster.device_classes``."""
        if len(self.pipelines) != len(cluster.pipelines):
            raise ValueError("config/cluster pipeline count mismatch")
        classes = cluster.device_classes
        tot = [0.0] * len(classes)
        for cfg, pipe in zip(self.pipelines, cluster.pipelines):
            for c, v in zip(range(len(classes)),
                            cfg.cost_by_class(pipe, classes)):
                tot[c] += v
        return tuple(tot)

    def fits(self, cluster: ClusterModel) -> bool:
        """Does the joint allocation fit the shared budget — every class's
        budget under per-class budgets, the scalar C otherwise?"""
        if cluster.is_hetero:
            return all(c <= b + _COST_EPS
                       for c, b in zip(self.cost_by_class(cluster),
                                       cluster.budget_vector))
        return self.cost(cluster) <= cluster.cores + _COST_EPS

    def n_changes(self, other: "ClusterConfig") -> int:
        """How many pipelines differ between two joint configurations —
        the per-interval switch count the reconfiguration budget caps and
        the §5.3 adaptation penalty is charged per unit of."""
        if len(self.pipelines) != len(other.pipelines):
            raise ValueError("config pipeline count mismatch")
        return sum(1 for a, b in zip(self.pipelines, other.pipelines)
                   if a != b)

    def transition_cost(self, cluster: ClusterModel,
                        serving: "ClusterConfig") -> float:
        """Peak cores needed to move from ``serving`` to this config when
        every changed pipeline's old replica fleet serves out a §5.3
        adaptation window: ``sum_p max(old_p, new_p)``.

        During a transition both fleets are provisioned — the old one is
        still serving, the new one is starting — so the honest capacity
        charge per pipeline is the larger of the two allocations, not the
        post-transition one.  This is what the overlap-aware solver plans
        against and what the simulator's ledger holds until the deferred
        apply event fires."""
        if len(self.pipelines) != len(serving.pipelines):
            raise ValueError("config pipeline count mismatch")
        if len(self.pipelines) != len(cluster.pipelines):
            raise ValueError("config/cluster pipeline count mismatch")
        return float(sum(max(new.cost(pipe), old.cost(pipe))
                         for new, old, pipe in zip(self.pipelines,
                                                   serving.pipelines,
                                                   cluster.pipelines)))

    def transition_cost_by_class(self, cluster: ClusterModel,
                                 serving: "ClusterConfig"
                                 ) -> Tuple[float, ...]:
        """Per-class peak transition charge: ``max(old, new)`` per pipeline
        taken *elementwise per device class* (the old fleet's GPU replicas
        and the new fleet's CPU replicas coexist through the window), then
        summed across pipelines.  Aligned with ``cluster.device_classes``."""
        if len(self.pipelines) != len(serving.pipelines):
            raise ValueError("config pipeline count mismatch")
        if len(self.pipelines) != len(cluster.pipelines):
            raise ValueError("config/cluster pipeline count mismatch")
        classes = cluster.device_classes
        tot = [0.0] * len(classes)
        for new, old, pipe in zip(self.pipelines, serving.pipelines,
                                  cluster.pipelines):
            nv = new.cost_by_class(pipe, classes)
            ov = old.cost_by_class(pipe, classes)
            for c in range(len(classes)):
                tot[c] += max(nv[c], ov[c])
        return tuple(tot)

    def fits_transition(self, cluster: ClusterModel,
                        serving: "ClusterConfig") -> bool:
        """Does the move from ``serving`` to this config fit the budget
        *throughout* the adaptation window (old and new fleets counted at
        ``max`` — per device class under per-class budgets), not merely
        after it?"""
        if cluster.is_hetero:
            return all(
                c <= b + _COST_EPS
                for c, b in zip(self.transition_cost_by_class(cluster,
                                                              serving),
                                cluster.budget_vector))
        return self.transition_cost(cluster, serving) \
            <= cluster.cores + _COST_EPS


def single(pipe: PipelineModel, cores: float = float("inf")) -> ClusterModel:
    """Wrap one pipeline as a cluster (the N=1 special case)."""
    return ClusterModel(pipe.name, (pipe,), cores)


def proportional_split(cluster: ClusterModel,
                       demands: Sequence[float]) -> Tuple[float, ...]:
    """Split the core budget proportionally to per-pipeline demand (RPS).

    This is the static-split baseline's arbitration rule: pipeline i gets
    ``C * lam_i / sum(lam)``; the joint solver instead trades cores across
    pipelines by marginal objective gain.
    """
    if len(demands) != cluster.n_pipelines:
        raise ValueError("one demand per pipeline required")
    if cluster.cores == float("inf"):
        return tuple(float("inf") for _ in demands)
    total = float(sum(max(float(d), 0.0) for d in demands))
    if total <= 0.0:
        return tuple(cluster.cores / cluster.n_pipelines for _ in demands)
    return tuple(cluster.cores * max(float(d), 0.0) / total for d in demands)


def proportional_split_by_class(cluster: ClusterModel,
                                demands: Sequence[float]
                                ) -> Tuple[Tuple[float, ...], ...]:
    """Per-class proportional split: pipeline i gets the demand share
    ``B_c * lam_i / sum(lam)`` of *every* class budget ``B_c`` — the
    strongest static-split strawman on a heterogeneous pool (each share
    keeps the pool's class mix; the joint solver instead trades classes
    across pipelines).  Returns one per-class cap vector per pipeline,
    aligned with ``cluster.device_classes``."""
    if len(demands) != cluster.n_pipelines:
        raise ValueError("one demand per pipeline required")
    budgets = cluster.budget_vector
    total = float(sum(max(float(d), 0.0) for d in demands))
    if total <= 0.0:
        return tuple(tuple(b / cluster.n_pipelines for b in budgets)
                     for _ in demands)
    return tuple(tuple(b * max(float(d), 0.0) / total for b in budgets)
                 for d in demands)

"""Baseline policies from the paper's evaluation (§5.1), plus their
cluster-level variants (§6 discussion).

* FA2 (Razavi et al., RTAS'22): optimal joint (batch, replicas) per stage for
  cost, but the model variant is FIXED.  FA2-low pins every stage to its
  lightest variant, FA2-high to its heaviest.  With the variant fixed, the
  minimum-cost feasible configuration is exactly what our enumeration solver
  returns with alpha = 0 (pure cost minimization) — equivalent to FA2's DP.
* RIM (Hu et al., IoTDI'21): model switching only; replication is pinned to a
  static high value, batching added for fairness (as the paper does).  RIM
  maximizes accuracy subject to latency/throughput feasibility.

Cluster level: the joint IPA policy (``cluster_ipa``) arbitrates one
frontier point per pipeline under the shared core budget via the knapsack
in ``optimizer.solve_cluster``; the static-split baselines
(``cluster_split``) first divide the budget proportionally to per-pipeline
demand and then run a per-pipeline policy inside each share — the
INFaaS/InferLine-style strawman the joint solver has to beat.

All baselines plan against the same queueing model the simulator enforces:
``core.queueing`` provides both the analytical Eq. 7 delay (used by the
enumeration solver via ``PipelineConfig.latency``) and the batch-formation
``wait_bound`` the simulator arms as its dispatch timeout, so a config a
baseline deems feasible is judged by identical queueing assumptions at
simulation time.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import optimizer as OPT
from repro_torch.core.cluster import (ClusterConfig, ClusterModel,
                                proportional_split,
                                proportional_split_by_class)
from repro_torch.core.pipeline import PipelineModel


def _over_cap(sol: OPT.Solution, pipe: PipelineModel, cap,
              classes) -> bool:
    """Does a solved config overflow its static-split share — the scalar
    cap, or (heterogeneous) any class's cap?"""
    if classes is None:
        return sol.cost > cap + 1e-9
    return any(cv > c + 1e-9
               for cv, c in zip(sol.config.cost_by_class(pipe, classes),
                                cap))


def fa2(pipe: PipelineModel, arrival: float, level: str = "low",
        max_replicas: int = OPT.DEFAULT_MAX_REPLICAS,
        solver: str = "vec") -> OPT.Solution:
    """FA2-low / FA2-high: fixed variants, min-cost (batch, replicas).

    ``solver`` names any ``optimizer.solve`` solver: ``vec`` (the float64
    broadcast hot path — default), ``brute`` (the plain-python oracle,
    bit-identical to ``vec``), or ``enum`` (the float32 torch cross-check,
    on the card)."""
    variants = [s.lightest.name if level == "low" else s.heaviest.name
                for s in pipe.stages]
    obj = OPT.Objective(alpha=0.0, beta=1.0, delta=1e-6, metric="pas")
    return OPT.solve(pipe, arrival, obj, solver=solver,
                     max_replicas=max_replicas, restrict_variants=variants)


def rim(pipe: PipelineModel, arrival: float, static_replicas: int = 24,
        max_replicas: int = OPT.DEFAULT_MAX_REPLICAS,
        solver: str = "vec") -> OPT.Solution:
    """RIM: variant switching at a static (over-provisioned) replication.
    ``solver`` as in ``fa2``."""
    obj = OPT.Objective(alpha=1.0, beta=0.0, delta=1e-6, metric="pas")
    return OPT.solve(pipe, arrival, obj, solver=solver,
                     max_replicas=max_replicas,
                     fixed_replicas=static_replicas)


def ipa(pipe: PipelineModel, arrival: float,
        obj: Optional[OPT.Objective] = None,
        max_replicas: int = OPT.DEFAULT_MAX_REPLICAS,
        solver: str = "auto") -> OPT.Solution:
    return OPT.solve(pipe, arrival, obj or OPT.Objective(),
                     solver=solver, max_replicas=max_replicas)


POLICIES = {
    "ipa": lambda pipe, lam, **kw: ipa(pipe, lam, **kw),
    "fa2_low": lambda pipe, lam, **kw: fa2(pipe, lam, "low", **kw),
    "fa2_high": lambda pipe, lam, **kw: fa2(pipe, lam, "high", **kw),
    "rim": lambda pipe, lam, **kw: rim(pipe, lam, **kw),
}


# ---------------------------------------------------------------------------
# cluster level
# ---------------------------------------------------------------------------
def _objective_of(sol: OPT.Solution, pipe: PipelineModel,
                  obj: OPT.Objective) -> float:
    """A feasible solution's objective re-evaluated under ``obj`` (fa2/rim
    solve under their own internal weights)."""
    from repro_torch.core import accuracy as ACC
    if obj.metric == "pas":
        acc = sol.pas
    elif obj.metric == "pas_prime":
        acc = ACC.pas_prime_of(sol.config, pipe)
    else:                                # log_pas: sum of log(a/100)
        acc = float(np.log(max(sol.pas, 1e-9) / 100.0))
    bat = sum(sc.batch for sc in sol.config.stages)
    return obj.alpha * acc - obj.beta * sol.cost - obj.delta * bat


def cluster_ipa(cluster: ClusterModel, lams: Sequence[float],
                obj: Optional[OPT.Objective] = None,
                max_replicas: int = OPT.DEFAULT_MAX_REPLICAS,
                current=None, switch_cost: float = 0.0,
                switch_budget: Optional[int] = None,
                sla_weights: Optional[Sequence[float]] = None,
                overlap: bool = False, serving=None,
                cache: Optional[OPT.FrontierCache] = None
                ) -> OPT.ClusterSolution:
    """Joint arbitration: one knapsack over per-pipeline Pareto frontiers
    under the shared core budget.  ``current``/``switch_cost``/
    ``switch_budget``/``sla_weights``/``overlap``/``serving`` make it
    switch-cost-aware, SLA-weighted and transition-overlap-aware (the knob
    semantics are documented in one place: ``optimizer.solve_cluster``);
    the defaults are the PR 2 behaviour bit-for-bit.  ``cache``: an
    optional ``optimizer.FrontierCache`` memoizing the frontier builds
    across adaptation intervals (bit-identical with exact keying)."""
    return OPT.solve_cluster(cluster, lams, obj or OPT.Objective(),
                             max_replicas=max_replicas, current=current,
                             switch_cost=switch_cost,
                             switch_budget=switch_budget,
                             sla_weights=sla_weights,
                             overlap=overlap, serving=serving,
                             cache=cache)


def cluster_split(cluster: ClusterModel, lams: Sequence[float],
                  inner: str = "ipa",
                  obj: Optional[OPT.Objective] = None,
                  max_replicas: int = OPT.DEFAULT_MAX_REPLICAS,
                  cache: Optional[OPT.FrontierCache] = None
                  ) -> OPT.ClusterSolution:
    """Proportional static split: pipeline i plans alone inside its demand
    share ``C * lam_i / sum(lam)`` of the core budget.

    ``inner`` picks the per-pipeline policy run inside each share: ``ipa``
    (cost-capped frontier pick), ``fa2_low`` / ``fa2_high`` / ``rim``
    (their usual solutions, rejected when they overflow the share).  A
    pipeline whose share is infeasible holds its previous config at the
    adapter level — its Solution comes back infeasible here.

    All returned objectives (per-pipeline and summed) are re-expressed
    under the caller's ``obj`` regardless of ``inner`` — fa2/rim solve
    with their own internal weights, and their raw objectives would be
    incommensurable with ``cluster_ipa``'s.  The summed objective is also
    SLA-weighted by the cluster's own ``sla_weights`` (per-pipeline
    objectives stay raw, as in ``cluster_ipa``), so joint-vs-split
    objective comparisons remain commensurable on weighted clusters.

    ``cache``: optional ``optimizer.FrontierCache`` for the inner ``ipa``
    sub-problem's frontier builds (the other inners do not build
    frontiers and ignore it).

    Heterogeneous clusters split *every class budget* by the same demand
    share (``proportional_split_by_class``) and cap the inner problems per
    class — the strongest static-split strawman the ``hetero`` benchmark
    measures the joint solver against.
    """
    t0 = time.perf_counter()
    o = obj or OPT.Objective()
    weights = cluster.weights
    hetero = getattr(cluster, "is_hetero", False)
    classes = cluster.device_classes if hetero else None
    if hetero:
        caps = proportional_split_by_class(cluster, lams)
    else:
        caps = proportional_split(cluster, lams)
    sols = []
    for pipe, lam, cap in zip(cluster.pipelines, lams, caps):
        if inner == "ipa":
            sol = OPT.solve_capped(pipe, lam, o, cap, max_replicas,
                                   cache=cache, classes=classes)
        elif inner in ("fa2_low", "fa2_high"):
            sol = fa2(pipe, lam, inner.split("_")[1], max_replicas)
            if sol.feasible and _over_cap(sol, pipe, cap, classes):
                sol = OPT._infeasible(t0, "split_" + inner)
            if sol.feasible:
                sol.objective = _objective_of(sol, pipe, o)
        elif inner == "rim":
            sol = rim(pipe, lam, max_replicas=max_replicas)
            if sol.feasible and _over_cap(sol, pipe, cap, classes):
                sol = OPT._infeasible(t0, "split_rim")
            if sol.feasible:
                sol.objective = _objective_of(sol, pipe, o)
        else:
            raise ValueError(inner)
        sols.append(sol)
    feasible = all(s.feasible for s in sols)
    cfg = (ClusterConfig(tuple(s.config for s in sols)) if feasible else None)
    return OPT.ClusterSolution(
        config=cfg, per_pipeline=sols,
        objective=float(sum(w * s.objective for w, s in zip(weights, sols)))
        if feasible else -np.inf,
        cost=float(sum(s.cost for s in sols if s.feasible)),
        feasible=feasible, solve_time=time.perf_counter() - t0,
        solver=f"split_{inner}")


CLUSTER_POLICIES = {
    "ipa": lambda cl, lams, **kw: cluster_ipa(cl, lams, **kw),
    "split_ipa": lambda cl, lams, **kw: cluster_split(cl, lams, "ipa", **kw),
    "split_fa2_low": lambda cl, lams, **kw: cluster_split(
        cl, lams, "fa2_low", **kw),
    "split_fa2_high": lambda cl, lams, **kw: cluster_split(
        cl, lams, "fa2_high", **kw),
    "split_rim": lambda cl, lams, **kw: cluster_split(cl, lams, "rim", **kw),
}

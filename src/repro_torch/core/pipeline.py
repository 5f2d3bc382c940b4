"""Control-plane data model: model variants, stages, pipelines (paper §2-4).

A ``ModelVariant`` is what the offline profiler produces: an accuracy scalar,
a base resource allocation R_m (Eq. 1) and a quadratic latency model
l(b) = alpha b^2 + beta b + gamma fitted on power-of-two batch profiles
(§4.2).  A ``StageModel`` is a task with its variant family and per-stage
SLA; a ``PipelineModel`` holds a stage *graph*: by default a linear chain
(one input/output, per §4.1), or — via ``parents`` — a general DAG with
fan-out/fan-in the way IPA §5.1's real topologies and InferLine's
prediction DAGs are shaped (video → [detector ∥ classifier] → join).

DAG semantics in one paragraph: stages are listed in topological order;
``parents[i]`` names the stages feeding stage ``i`` (``parents[0]`` must be
empty — stage 0 is the single source — and exactly one stage, necessarily
the last, is referenced by nobody: the single sink).  Fan-out replicates a
request to every child, so *every* stage still sees the full arrival rate
lambda and Eq. 10c applies per branch unchanged.  Fan-in (a join) waits
for all parents.  The end-to-end latency bound (Eq. 7 per stage) is taken
along the *critical path*: the maximum over source→sink paths of the
per-stage service + queue-delay sums, because parallel branches overlap in
time rather than serialize.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BATCH_CHOICES = (1, 2, 4, 8, 16, 32, 64)     # power-of-two profiling grid §4.2


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One device class's measured profile of a model variant: the same
    (accuracy, R_m, quadratic latency) triple the offline profiler produces
    per hardware class (INFaaS-style variant+hardware selection).  Accuracy
    is per-class because hardware-specific builds (quantized edge binaries,
    reduced-precision GPU kernels) genuinely move the task measure."""
    device: str                          # class name, e.g. "cpu" / "gpu"
    latency_coeffs: Tuple[float, float, float]
    base_alloc: int                      # R_m in this class's budget units
    accuracy: float


@dataclasses.dataclass(frozen=True)
class ModelVariant:
    name: str
    accuracy: float                      # task measure, higher-is-better §4.1
    base_alloc: int                      # R_m: cores/chips per replica (Eq. 1)
    latency_coeffs: Tuple[float, float, float]   # (α, β, γ): l = α·b² + β·b + γ
    params_m: float = 0.0                # millions of parameters (metadata)
    # per-device-class profile table.  ``None`` (the default) is the legacy
    # single-class variant: it runs on exactly one class, "cpu", served by
    # the variant's own (accuracy, base_alloc, latency_coeffs) fields
    # through the identical float path — the device axis is invisible.
    device_profiles: Optional[Tuple[DeviceProfile, ...]] = None

    @property
    def device_classes(self) -> Tuple[str, ...]:
        """Device classes this variant can run on (legacy: ``("cpu",)``)."""
        if self.device_profiles is None:
            return ("cpu",)
        return tuple(dp.device for dp in self.device_profiles)

    def _fields_on(self, device: Optional[str]
                   ) -> Tuple[Tuple[float, float, float], int, float]:
        """(latency_coeffs, base_alloc, accuracy) on ``device``.

        ``None`` always means the variant's own fields (every legacy call
        site), as does ``"cpu"`` on a single-class variant — both hit the
        exact pre-device float path."""
        if device is None:
            return self.latency_coeffs, self.base_alloc, self.accuracy
        if self.device_profiles is None:
            if device != "cpu":
                raise KeyError(
                    f"variant {self.name} has no device class {device!r}")
            return self.latency_coeffs, self.base_alloc, self.accuracy
        for dp in self.device_profiles:
            if dp.device == device:
                return dp.latency_coeffs, dp.base_alloc, dp.accuracy
        raise KeyError(f"variant {self.name} has no device class {device!r}")

    def alloc(self, device: Optional[str] = None) -> int:
        """R_m on a device class (legacy fields when ``device`` is None)."""
        return self._fields_on(device)[1]

    def acc(self, device: Optional[str] = None) -> float:
        """Accuracy on a device class (legacy fields when ``device`` is
        None)."""
        return self._fields_on(device)[2]

    def latency(self, batch, device: Optional[str] = None) -> np.ndarray:
        a, b, c = self._fields_on(device)[0]
        batch = np.asarray(batch, dtype=np.float64)
        return a * batch ** 2 + b * batch + c

    def throughput(self, batch, device: Optional[str] = None) -> np.ndarray:
        """Per-replica RPS at batch size b (requests, not batches)."""
        batch = np.asarray(batch, dtype=np.float64)
        return batch / self.latency(batch, device)


@dataclasses.dataclass(frozen=True)
class StageModel:
    name: str
    variants: Tuple[ModelVariant, ...]
    sla: float                           # per-stage SLA_s (§4.2, Swayam x5)
    batch_choices: Tuple[int, ...] = BATCH_CHOICES

    def variant(self, name: str) -> ModelVariant:
        for v in self.variants:
            if v.name == name:
                return v
        raise KeyError(name)

    @property
    def lightest(self) -> ModelVariant:
        """Cheapest variant; equal-alloc ties prefer the *more* accurate."""
        return min(self.variants, key=lambda v: (v.base_alloc, -v.accuracy))

    @property
    def heaviest(self) -> ModelVariant:
        """Most accurate variant; equal-accuracy ties prefer the cheaper."""
        return max(self.variants, key=lambda v: (v.accuracy, -v.base_alloc))


@functools.lru_cache(maxsize=512)
def _all_paths(parents: Tuple[Tuple[int, ...], ...]) -> Tuple[Tuple[int, ...], ...]:
    """All source→sink stage paths, deterministic (children ascending)."""
    n = len(parents)
    children: List[List[int]] = [[] for _ in range(n)]
    for i, ps in enumerate(parents):
        for p in ps:
            children[p].append(i)
    out: List[Tuple[int, ...]] = []
    stack: List[int] = [0]

    def walk(i: int) -> None:
        if not children[i]:
            out.append(tuple(stack))
            return
        for c in children[i]:
            stack.append(c)
            walk(c)
            stack.pop()

    walk(0)
    return tuple(out)


def _chain_parents(n: int) -> Tuple[Tuple[int, ...], ...]:
    return tuple(() if i == 0 else (i - 1,) for i in range(n))


@dataclasses.dataclass(frozen=True)
class PipelineModel:
    """Stage graph.  ``parents=None`` (the default) is a linear chain;
    otherwise ``parents[i]`` lists the stages feeding stage ``i``.  Stages
    must be in topological order (each parent index < its child), which
    makes acyclicity free; stage 0 is the single source and exactly one
    stage — necessarily the last — may be a sink.  ``sla_override`` pins
    SLA_P explicitly (used e.g. by ``linearize`` so a chain-shaped planning
    model keeps the DAG's end-to-end budget)."""
    name: str
    stages: Tuple[StageModel, ...]
    parents: Optional[Tuple[Tuple[int, ...], ...]] = None
    sla_override: Optional[float] = None

    def __post_init__(self):
        if self.parents is None:
            return
        n = len(self.stages)
        if len(self.parents) != n:
            raise ValueError(
                f"parents has {len(self.parents)} entries for {n} stages")
        norm = tuple(tuple(sorted({int(p) for p in ps}))
                     for ps in self.parents)
        object.__setattr__(self, "parents", norm)
        if n == 0:
            return
        if norm[0] != ():
            raise ValueError("stage 0 must be the single source (no parents)")
        referenced = set()
        for i in range(1, n):
            ps = norm[i]
            if not ps:
                raise ValueError(
                    f"stage {i} has no parents: only stage 0 may be a source")
            if ps[0] < 0 or ps[-1] >= i:
                raise ValueError(
                    f"stage {i} parents {ps} must reference earlier stages "
                    "only (stages are listed in topological order)")
            referenced.update(ps)
        for i in range(n - 1):
            if i not in referenced:
                raise ValueError(
                    f"stage {i} feeds nothing: the graph must have a single "
                    f"sink (stage {n - 1})")

    # -- graph accessors ---------------------------------------------------
    @property
    def is_chain(self) -> bool:
        """True for a degenerate path graph (incl. explicit chain parents)."""
        return (self.parents is None
                or self.parents == _chain_parents(len(self.stages)))

    @property
    def effective_parents(self) -> Tuple[Tuple[int, ...], ...]:
        if self.parents is not None:
            return self.parents
        return _chain_parents(len(self.stages))

    def parents_of(self, i: int) -> Tuple[int, ...]:
        return self.effective_parents[i]

    def children_of(self, i: int) -> Tuple[int, ...]:
        return tuple(c for c, ps in enumerate(self.effective_parents)
                     if i in ps)

    def paths(self) -> Tuple[Tuple[int, ...], ...]:
        """All source→sink stage-index paths (a chain has exactly one)."""
        if self.parents is None:
            return (tuple(range(len(self.stages))),)
        return _all_paths(self.parents)

    def critical_path(self, weights: Optional[Sequence[float]] = None
                      ) -> Tuple[int, ...]:
        """The source→sink path maximizing the per-stage weight sum
        (default weights: the stage SLAs).  Ties break on path order."""
        w = ([s.sla for s in self.stages] if weights is None
             else [float(x) for x in weights])
        return max(self.paths(), key=lambda path: sum(w[i] for i in path))

    def linearize(self) -> "PipelineModel":
        """Chain-shaped planning model over the same stages, pinned to this
        pipeline's end-to-end SLA — what a chain-only planner (the
        pre-DAG IPA) would be forced to plan against: every stage's
        latency charged against the one budget, branches serialized."""
        return PipelineModel(self.name + "-linearized", self.stages,
                             parents=None, sla_override=self.sla)

    @property
    def sla(self) -> float:
        """SLA_P: sum of per-stage SLAs (§4.2) along the critical path —
        for a chain that is the plain sum over all stages."""
        if self.sla_override is not None:
            return float(self.sla_override)
        if self.parents is None:
            return float(sum(s.sla for s in self.stages))
        return float(max(sum(self.stages[i].sla for i in path)
                         for path in self.paths()))


@dataclasses.dataclass(frozen=True)
class StageConfig:
    variant: str
    batch: int
    replicas: int
    # device class the replicas are placed on.  The default keeps every
    # legacy 3-field construction (and its equality/hash) meaningful: a
    # single-class deployment is all-"cpu".
    device: str = "cpu"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    stages: Tuple[StageConfig, ...]

    def cost(self, pipe: PipelineModel) -> float:
        """Sum_s n_s * R_s (paper's cost: replicas x cores-per-replica),
        totalled across device classes."""
        return float(sum(
            sc.replicas * st.variant(sc.variant).alloc(sc.device)
            for sc, st in zip(self.stages, pipe.stages)))

    def cost_by_class(self, pipe: PipelineModel,
                      classes: Sequence[str]) -> Tuple[float, ...]:
        """Per-device-class cost vector aligned with ``classes`` — the
        knapsack weight / ledger charge under per-class budgets.  A stage
        placed on a class outside ``classes`` is a configuration error."""
        tot: Dict[str, float] = {c: 0.0 for c in classes}
        for sc, st in zip(self.stages, pipe.stages):
            if sc.device not in tot:
                raise KeyError(
                    f"stage on device class {sc.device!r} but the budget "
                    f"only covers {tuple(classes)}")
            tot[sc.device] += sc.replicas * st.variant(sc.variant).alloc(
                sc.device)
        return tuple(float(tot[c]) for c in classes)

    def latency(self, pipe: PipelineModel, arrival: float,
                latency_model: str = "worst_case") -> float:
        """End-to-end model latency + queueing delay (Eq. 7 + 10b).

        For a chain this sums every stage; for a DAG it is the critical-
        path bound — the max over source→sink paths of the per-stage
        (service + queue delay) sums, since parallel branches overlap.
        Fan-out replicates arrivals, so each stage's queue delay is still
        priced at the full ``arrival`` rate.

        ``latency_model``: ``"worst_case"`` (default — Eq. 7's bound,
        bit-identical to the paper's planner) or ``"expected"`` (mean
        batch-formation wait + M/M/c Erlang-C wait across the stage's
        configured replicas; see ``core.queueing.expected_wait``).
        """
        from repro_torch.core.queueing import expected_wait, queue_delay
        if pipe.is_chain:
            tot = 0.0
            for sc, st in zip(self.stages, pipe.stages):
                v = st.variant(sc.variant)
                svc = float(v.latency(sc.batch, sc.device))
                if latency_model == "expected":
                    tot += svc + expected_wait(sc.batch, arrival, sc.replicas,
                                               svc)
                elif latency_model == "worst_case":
                    tot += svc + queue_delay(sc.batch, arrival)
                else:
                    raise ValueError(latency_model)
            return tot
        terms = []
        for sc, st in zip(self.stages, pipe.stages):
            v = st.variant(sc.variant)
            svc = float(v.latency(sc.batch, sc.device))
            if latency_model == "expected":
                terms.append(svc + expected_wait(sc.batch, arrival,
                                                 sc.replicas, svc))
            elif latency_model == "worst_case":
                terms.append(svc + float(queue_delay(sc.batch, arrival)))
            else:
                raise ValueError(latency_model)
        best = None
        for path in pipe.paths():
            tot = 0.0
            for i in path:
                tot += terms[i]
            if best is None or tot > best:
                best = tot
        return float(best)

    def supports(self, pipe: PipelineModel, arrival: float) -> bool:
        """Throughput constraint 10c for every stage.

        Fan-out replicates the arrival stream to every child (and a join
        emits once per joined request), so each stage of a DAG sees the
        full rate lambda — the per-stage check is unchanged.
        """
        for sc, st in zip(self.stages, pipe.stages):
            v = st.variant(sc.variant)
            if sc.replicas * float(v.throughput(sc.batch, sc.device)) \
                    < arrival - 1e-9:
                return False
        return True

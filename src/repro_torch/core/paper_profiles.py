"""The paper's five pipelines (Fig. 6) with Appendix-A variant tables.

The archive's measured latency profiles are not shipped with the paper, so
we reconstruct them from the anchors the paper *does* give:

  * l(1) anchors: YOLOv5n = 80 ms, ResNet18 = 75 ms (Tables 2/3),
  * per-stage SLA = 5 x mean batch-1 latency (§4.2) reproduces Table 6,
  * batch scaling l(8)/l(1) = 6.0 (Table 3: YOLOv5n 80 -> 481 ms),
  * across variants of a task, l(1) scales as params^0.6 (fits the
    YOLOv5n->m 80 -> ~347 ms and ResNet18->50 75 -> ~135 ms anchors).

With these, Eq. 1 run through our profiler reproduces the appendix base
allocations (e.g. YOLO: 1/1/2/4/8 at th=4, Table 7) — validated in tests.
Accuracies and parameter counts are the appendix tables verbatim.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.pipeline import ModelVariant, PipelineModel, StageModel
from repro_torch.core.profiler import Profile, build_stage

BATCH_SHAPE = (0.3, 0.7, 0.001)     # l(b) = l1 * (c + m*b + q*b^2)
PARAM_EXP = 0.6


def _latency_curve(l1: float, batches: Sequence[int]) -> List[float]:
    c, m, q = BATCH_SHAPE
    denom = c + m + q
    return [l1 * (c + m * b + q * b * b) / denom for b in batches]


def _make_profiles(table: Sequence[Tuple[str, float, float]], anchor_l1: float,
                   batches: Sequence[int]) -> List[Profile]:
    """table rows: (name, params_m, accuracy); anchor_l1 = l(1) of row 0."""
    p0 = table[0][1] ** PARAM_EXP
    out = []
    for name, params_m, acc in table:
        l1 = anchor_l1 * (params_m ** PARAM_EXP) / p0
        out.append(Profile(name, list(batches), _latency_curve(l1, batches),
                           acc, params_m))
    return out


# --------------------------------------------------------------------------
# Appendix A tables: (name, params M, accuracy-like measure)
# --------------------------------------------------------------------------
YOLO = [("yolov5n", 1.9, 45.7), ("yolov5s", 7.2, 56.8), ("yolov5m", 21.2, 64.1),
        ("yolov5l", 46.5, 67.3), ("yolov5x", 86.7, 68.9)]               # mAP
RESNET = [("resnet18", 11.7, 69.75), ("resnet34", 21.8, 73.31),
          ("resnet50", 25.5, 76.13), ("resnet101", 44.54, 77.37),
          ("resnet152", 60.2, 78.31)]                                    # acc
AUDIO = [("s2t-small", 29.5, 58.72), ("s2t-medium", 71.2, 64.88),
         ("wav2vec2-base", 94.4, 66.15), ("s2t-large", 267.8, 66.74),
         ("wav2vec2-large", 315.5, 72.35)]                               # 1-WER
QA = [("roberta-base", 277.45, 77.14), ("roberta-large", 558.8, 83.79)]  # F1
SUM = [("distilbart-1-1", 82.9, 32.26), ("distilbart-12-1", 221.5, 33.37),
       ("distilbart-6-6", 229.9, 35.73), ("distilbart-12-3", 255.1, 36.39),
       ("distilbart-9-6", 267.7, 36.61), ("distilbart-12-6", 305.5, 36.99)]
SENT = [("distilbert", 66.9, 79.6), ("bert", 109.4, 79.9),
        ("roberta", 355.3, 83.0)]                                        # acc
LANGID = [("roberta-langid", 278.0, 79.62)]
NMT = [("opus-mt-fr-en", 74.6, 33.1), ("opus-mt-big-fr-en", 230.6, 34.4)]  # BLEU

# task -> (table, anchor l(1) seconds, threshold th RPS, batch choices)
TASKS: Dict[str, tuple] = {
    "object_detection": (YOLO, 0.080, 4, (1, 2, 4, 8)),
    "object_classification": (RESNET, 0.075, 4, (1, 2, 4, 8)),
    "audio": (AUDIO, 0.640, 1, (1, 2, 4, 8)),
    "qa": (QA, 0.120, 1, (1, 2, 4, 8)),
    "summarisation": (SUM, 0.280, 5, (1, 2, 4, 8)),
    "summarisation_long": (SUM, 1.400, 5, (1, 2, 4, 8)),   # NLP-pipeline inputs
    "sentiment": (SENT, 0.130, 1, (1, 2, 4, 8)),
    "language_id": (LANGID, 0.195, 4, (1, 2, 4, 8)),
    "translation": (NMT, 0.540, 4, (1, 2, 4, 8)),
}


def task_profiles(task: str) -> List[Profile]:
    table, anchor, th, batches = TASKS[task]
    return _make_profiles(table, anchor, batches)


def task_stage(task: str, name: str = None) -> StageModel:
    table, anchor, th, batches = TASKS[task]
    profs = _make_profiles(table, anchor, batches)
    return build_stage(name or task, profs, th=th, batch_choices=batches,
                       max_batch=max(batches))


# --------------------------------------------------------------------------
# the five pipelines of Fig. 6
# --------------------------------------------------------------------------
def video() -> PipelineModel:
    return PipelineModel("video", (task_stage("object_detection"),
                                   task_stage("object_classification")))


def audio_qa() -> PipelineModel:
    return PipelineModel("audio-qa", (task_stage("audio"), task_stage("qa")))


def audio_sent() -> PipelineModel:
    return PipelineModel("audio-sent", (task_stage("audio"),
                                        task_stage("sentiment")))


def sum_qa() -> PipelineModel:
    return PipelineModel("sum-qa", (task_stage("summarisation"),
                                    task_stage("qa")))


def nlp() -> PipelineModel:
    return PipelineModel("nlp", (task_stage("language_id"),
                                 task_stage("summarisation_long"),
                                 task_stage("translation")))


PIPELINES = {
    "video": video, "audio-qa": audio_qa, "audio-sent": audio_sent,
    "sum-qa": sum_qa, "nlp": nlp,
}


# --------------------------------------------------------------------------
# DAG-shaped variants of the Fig. 6 topologies
#
# The paper's video pipeline runs its two models sequentially (detector
# crops feed the classifier), but the same two tasks can run as parallel
# branches over the decoded frame (the InferLine-style prediction DAG),
# joined by a fusion stage.  These presets exercise the stage-graph
# machinery — fan-out, wait-for-all-parents joins, critical-path latency
# — over the paper's real variant tables.
# --------------------------------------------------------------------------
def passthrough_stage(name: str, latency: float = 0.002) -> StageModel:
    """A fixed-function stage (decoder, result fusion): one variant,
    accuracy 100 — the multiplicative PAS factor is exactly 1.0, so the
    stage never moves the pipeline's accuracy — one core, flat latency."""
    v = ModelVariant(name + "-fixed", 100.0, 1, (0.0, 0.0, latency))
    return StageModel(name, (v,), sla=5.0 * latency, batch_choices=(1, 2, 4, 8))


def video_fanout() -> PipelineModel:
    """decode → [object_detection ∥ object_classification] → fusion.

    The end-to-end budget is pinned at 1.5 s — tight enough that the
    large-batch service latencies (batch 8 ≈ 6 x batch 1, Table 3) fit
    only along the critical path, not serialized across both branches.
    That asymmetry is the operational reason to fan the two models out:
    a chain-shaped plan must give up batch economy (more replicas, more
    cores) exactly where the DAG plan keeps it."""
    return PipelineModel(
        "video-fanout",
        (passthrough_stage("decode"),
         task_stage("object_detection"),
         task_stage("object_classification"),
         passthrough_stage("fusion")),
        parents=((), (0,), (0,), (1, 2)),
        sla_override=1.5)


def network_edge_stage(name: str, delay: float = 0.060) -> StageModel:
    """A per-edge network link modelled as a stage: pure propagation delay.

    Zero-cost (``base_alloc`` 0 — a link consumes no budget in any device
    class, so no planner can ever spend cores on it) and accuracy-neutral
    (accuracy 100 → multiplicative PAS factor exactly 1.0).  Its only
    effect on a plan is the flat ``delay`` it adds to every source→sink
    path that crosses it — which is exactly how the edge-placement
    follow-up work charges WAN hops: latency on the path, nothing on the
    budget."""
    v = ModelVariant(name + "-link", 100.0, 0, (0.0, 0.0, delay))
    return StageModel(name, (v,), sla=5.0 * delay, batch_choices=(1,))


def video_edge(delay: float = 0.060) -> PipelineModel:
    """``video_fanout`` with the classification branch placed across a
    network edge: decode → [detect ∥ (uplink → classify)] → fusion.

    The uplink is a ``network_edge_stage``: it can lengthen the
    classification branch past the detection branch and thereby shift the
    critical path, but it never consumes budget — the planner's cost for
    this pipeline is identical to ``video_fanout``'s at every frontier
    point."""
    return PipelineModel(
        "video-edge",
        (passthrough_stage("decode"),
         task_stage("object_detection"),
         network_edge_stage("uplink", delay),
         task_stage("object_classification"),
         passthrough_stage("fusion")),
        parents=((), (0,), (0,), (2,), (1, 3)),
        sla_override=1.5)


def audio_fanout() -> PipelineModel:
    """audio → [qa ∥ sentiment] → fusion: one transcription feeding both
    downstream consumers of the paper's two audio pipelines in parallel."""
    return PipelineModel(
        "audio-fanout",
        (task_stage("audio"),
         task_stage("qa"),
         task_stage("sentiment"),
         passthrough_stage("fusion")),
        parents=((), (0,), (0,), (1, 2)))


DAG_PIPELINES = {
    "video-fanout": video_fanout, "audio-fanout": audio_fanout,
    "video-edge": video_edge,
}

# paper Appendix B objective weights per pipeline
PAPER_WEIGHTS = {
    "video": dict(alpha=2.0, beta=1.0, delta=1e-6),
    "audio-qa": dict(alpha=10.0, beta=0.5, delta=1e-6),
    "audio-sent": dict(alpha=30.0, beta=0.5, delta=1e-6),
    "sum-qa": dict(alpha=10.0, beta=0.5, delta=1e-6),
    "nlp": dict(alpha=40.0, beta=0.5, delta=1e-6),
}

from repro_torch.core import pipeline, profiler, queueing  # noqa: F401

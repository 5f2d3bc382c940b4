from repro_torch.core import (accuracy, adapter, baselines, cluster,  # noqa: F401
                              optimizer, paper_profiles, pipeline, predictor,
                              profiler, queueing, simulator, simulator_legacy,
                              study, trace)

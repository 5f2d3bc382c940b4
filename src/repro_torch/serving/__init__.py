from repro_torch.serving import batching, engine, request  # noqa: F401

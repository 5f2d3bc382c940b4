from repro_torch.serving import engine  # noqa: F401

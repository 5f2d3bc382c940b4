from repro_torch.training import checkpoint, data, optim, train  # noqa: F401

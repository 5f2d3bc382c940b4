from repro_torch.distributed import api  # noqa: F401

from repro_torch.models import convert, layers, model, stack  # noqa: F401

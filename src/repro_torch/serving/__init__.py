from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401

"""The system under test as the benchmark builds it: the port's
configuration for a benchmark configuration, and its model holding the
weights the benchmark drew (``repro_torch`` is imported here, inside the
functions, and nowhere else but the drivers)."""
from __future__ import annotations


def config(conf: dict):
    """``repro_torch``'s ``ArchConfig`` for ``conf``: the architecture it
    names with the settings under ``program`` applied, held to every size
    of ``conf["sizes"]`` that the port's config has."""
    from repro_torch.configs import get_config

    cfg = get_config(conf["arch"]).with_overrides(**conf.get("program", {}))
    wrong = {k: (getattr(cfg, k), v) for k, v in conf["sizes"].items()
             if hasattr(cfg, k) and getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"{conf['arch']}: the port's config departs from the benchmark's "
                         f"(port, benchmark): {wrong}")
    return cfg


def model(cfg, weights: dict):
    """The port's model for ``cfg`` holding ``weights`` (no copy): its
    leaves must be exactly the weights' names, shapes and dtypes."""
    from repro_torch.models.model_zoo import build_module

    module = build_module(cfg, "meta")
    have = {k: (tuple(p.shape), p.dtype) for k, p in module.named_parameters()}
    want = {k: (tuple(t.shape), t.dtype) for k, t in weights.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"the port's leaves and the benchmark's weights differ: {diff}")
    module.load_state_dict(weights, strict=True, assign=True)
    return module


def free_cuda() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

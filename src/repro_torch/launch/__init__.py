"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``):
``serve`` and ``train`` (the serve and training paths), ``dryrun`` (what a
cell of the production run costs each rank, without running it) and
``submit`` (ignis-submit), and the modules they share: ``mesh`` (meshes of
virtual ranks) and ``hlo_cost`` (the HLO text pricer).

The dry run's and ignis-submit's functions are exported lazily, so that
``python -m`` runs those modules without importing them twice."""
from repro_torch.launch.mesh import (  # noqa: F401
    Mesh, ambient_mesh, make_local_mesh, make_pp_mesh, make_production_mesh, use_mesh,
)

_LAZY = {"cell_key": "dryrun", "run_cell": "dryrun", "run_all": "dryrun",
         "submit": "submit"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
    return mod.main if name == "submit" else getattr(mod, name)

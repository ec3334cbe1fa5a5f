"""What the benchmark takes from the program under test: its entry
points' configuration objects built from a configuration file, and its
kernels' launch counters.  The only module of the harness that names the
port's configuration classes."""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil


def solver_config(fields: dict):
    from ndt_2d_tpu_torch.config import SolverConfig
    return SolverConfig(**fields)


def as_dict(cfg) -> dict:
    """A configuration dataclass as plain data (nested ones too)."""
    return dataclasses.asdict(cfg)


def launch_counts() -> dict:
    """Every kernel launch counter of the port: each module-level integer
    of ``ndt_2d_tpu_torch.kernels.*`` whose name ends in ``launches``, and
    each entry of such a dict, as ``module.name[.key]``."""
    import ndt_2d_tpu_torch.kernels as pkg
    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, value in vars(mod).items():
            if not name.endswith("launches"):
                continue
            if isinstance(value, int) and not isinstance(value, bool):
                out[f"{info.name}.{name}"] = value
            elif isinstance(value, dict):
                for k, v in value.items():
                    if isinstance(v, int):
                        out[f"{info.name}.{name}.{k}"] = v
    return out


def launches_since(before: dict) -> dict:
    """Launches of each counter since ``before`` (``launch_counts()``)."""
    now = launch_counts()
    return {k: v - before.get(k, 0) for k, v in now.items()}

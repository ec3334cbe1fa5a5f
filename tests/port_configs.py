"""Configuration helpers shared by the port's tests (not a test module).

The port keeps its own copies of the JAX package's configuration
dataclasses.  Tests build a port configuration and hand the JAX reference
the equal one that ``to_jax`` makes from it, field by field.
"""

import dataclasses

from ndt_2d_tpu import config as jax_config


def to_jax(cfg):
    """The JAX package's dataclass of the same name with the same fields
    as port config ``cfg``, nested configurations included."""
    cls = getattr(jax_config, type(cfg).__name__)
    return cls(**{f.name: (to_jax(v) if dataclasses.is_dataclass(v) else v)
                  for f in dataclasses.fields(cfg)
                  for v in [getattr(cfg, f.name)]})

"""The port's ``run`` and ``localize`` take the reference CLI's mapper flags
(ndt_2d_tpu/cli.py's parser) with its types and defaults: for one argv the
port's ``_mapper_config`` equals, field by field, the port counterpart of
the one JAX's ``_mapper_config`` builds (``port_configs.to_jax``)."""

import dataclasses

import pytest

from ndt_2d_tpu import cli as jax_cli
from ndt_2d_tpu_torch import cli
from port_configs import to_jax

FLAGS = ["--resolution", "0.1", "--minimum-travel-rotation", "0.4",
         "--rolling-depth", "7", "--occupancy-threshold", "0.35",
         "--max-range", "9.5", "--no-mapping"]


def configs(argv):
    ours = cli._mapper_config(cli._build_parser().parse_args(argv))
    ref = jax_cli._mapper_config(jax_cli._parse_for_test(argv))
    return to_jax(ours), ref


@pytest.mark.parametrize("grow", ["--auto-grow-grids",
                                  "--no-auto-grow-grids"])
@pytest.mark.parametrize("command", ["run", "localize"])
def test_reference_mapper_flags(command, grow):
    argv = [command, "--bag", "bag.npz", *FLAGS, grow]
    ours, ref = configs(argv)
    for f in dataclasses.fields(ref):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.resolution == 0.1 and ours.rolling_depth == 7
    assert ours.max_range == 9.5 and not ours.enable_mapping
    assert ours.auto_grow_grids == (grow == "--auto-grow-grids")


@pytest.mark.parametrize("command", ["run", "localize"])
def test_defaults_and_recipe(command):
    """Without the flags both keep MapperConfig's defaults; a recipe and
    the localizer's filter flags build the same configuration too."""
    for extra in ([], ["--recipe", "drift"],
                  ["--loop-closure-every", "12", "--robust-loss", "huber"]):
        ours, ref = configs([command, "--bag", "bag.npz", *extra])
        assert ours == ref
    if command == "localize":
        ours, ref = configs([command, "--bag", "bag.npz", "--particle-filter",
                             "--pf.max_particles", "3000"])
        assert ours == ref and ours.use_particle_filter
        assert ours.particle_filter.max_particles == 3000

"""The comparison that decides ``correct``: the port agrees with the plain
reference at a small size, the reference one precision below (the
control) fails it, and so does the timed path with a fault planted
underneath."""

import pytest
import torch

import portbench_cells as cells
from portbench import controls


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.make_root(str(tmp_path_factory.mktemp("root")))


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_the_port_agrees_with_the_reference(root, cell):
    out = cells.run(root, cell)
    assert out["correct"], out["compared"]
    for c in out["compared"].values():
        assert 0.0 <= c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_the_control_fails_and_the_program_passes(root, cell):
    program, control = controls.readings(root, cell, 5, 0.0, True,
                                         torch.device("cpu"), dirs=(root,))
    limits = cells.traffic(cells.CELLS[cell][2])["limits"]
    assert all(v <= limits[k] for k, v in program.items()), program
    assert any(v > limits[k] for k, v in control.items()), control


def _unchanged_solve(monkeypatch):
    from ndt_2d_tpu_torch.graph import solver
    original = solver.solve

    def solve(config, poses, *args, **kwargs):
        res = original(config, poses, *args, **kwargs)
        return res._replace(poses=poses.clone())
    monkeypatch.setattr(solver, "solve", solve)


def _half_the_constraints(monkeypatch):
    from ndt_2d_tpu_torch.graph import solver
    original = solver.solve

    def solve(config, poses, begin, end, transform, information,
              constraint_mask, *args, **kwargs):
        keep = constraint_mask.clone()
        keep[1::2] = False
        return original(config, poses, begin, end, transform, information,
                        keep, *args, **kwargs)
    monkeypatch.setattr(solver, "solve", solve)


def _altered_solve(monkeypatch):
    from ndt_2d_tpu_torch.graph import solver
    original = solver.solve

    def solve(config, poses, *args, **kwargs):
        res = original(config, poses, *args, **kwargs)
        moved = res.poses.clone()
        moved[len(moved) // 3, 0] += 0.1
        return res._replace(poses=moved)
    monkeypatch.setattr(solver, "solve", solve)


FAULTS = {
    # A step that returns its state unchanged: the solve returns the poses
    # it got.
    "batch-solve-unchanged": ("tiny.batch", _unchanged_solve),
    # Half of the batch left out: the solve sees every other constraint.
    "batch-half-the-constraints": ("tiny.batch", _half_the_constraints),
    # An answer altered where it is produced.
    "batch-solve-altered": ("tiny.batch", _altered_solve),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(root, fault, monkeypatch):
    cell, plant = FAULTS[fault]
    plant(monkeypatch)
    out = cells.run(root, cell)
    assert not out["correct"], out["compared"]

"""The port's multi-session map merge (mapping/merge.py) on the scenario of
tests/test_merge.py, and against the JAX package's merge.

Two sessions map overlapping parts of one office; session B's frame is an
arbitrary SE(2) away from A's (B drives the overlap the opposite way).  The
merge recovers the transform from appearance and full-heading NDT
registration (126 angles x 41 x 41 offsets: kernel K6's twin here) and
fuses the graphs.  The port's transform is held to the truth with the
reference test's bounds (0.15 m, 0.05 rad, merged ATE 0.2 m) and to the JAX
merge's of the same two graphs within 0.05 m and 0.02 rad (both quantize to
their 5 mm / 2.5 mrad fine lattices around coarse winners found on NDTs
that differ in the last bits).
"""

import numpy as np
import pytest
import torch

from ndt_2d_tpu.mapping import merge as jax_merge
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.core import pose as pose_ops
from ndt_2d_tpu_torch.graph.pose_graph import Graph
from ndt_2d_tpu_torch.mapping import merge
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.utils import metrics, sim

torch.set_num_threads(2)

MCFG = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
CFG = MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                   max_points_per_scan=512, loop_closure_every=10**9)
RANGE_MAX = 14.0


def world():
    # The office with a symmetry-breaking wall (the bare ring is 4-fold
    # symmetric and would alias).
    return np.concatenate([
        sim.make_office_world(16.0),
        np.asarray([[[1.0, 13.0], [3.0, 15.0]]]),
    ], axis=0)


def run_session(w, truth):
    """Map a trajectory with clean odometry on the port; the session's map
    frame is anchored at its first pose."""
    m = Mapper(CFG, device="cpu")
    for t in range(len(truth)):
        msg = sim.scan_at_pose(w, truth[t], n_beams=300,
                               range_max=RANGE_MAX, noise=0.01,
                               rng=np.random.default_rng(hash(t) % 2**31))
        m.process_scan(msg, truth[t])
    return m.graph


def compose(a, b):
    return pose_ops.compose(torch.tensor(a, dtype=torch.float32),
                            torch.tensor(b, dtype=torch.float32)).numpy()


def angle_error(a, b) -> float:
    return abs(float(pose_ops.normalize_angle(
        torch.tensor(a - b, dtype=torch.float32))))


@pytest.fixture(scope="module")
def sessions():
    w = world()
    n = 14
    # A: bottom corridor left -> middle; B: right -> middle, heading pi.
    truth_a = np.stack([np.linspace(2.0, 8.0, n),
                        np.full(n, 2.0), np.zeros(n)], axis=-1)
    truth_b = np.stack([np.linspace(12.0, 6.0, n),
                        np.full(n, 2.2), np.full(n, np.pi)], axis=-1)
    return w, truth_a, truth_b, run_session(w, truth_a), \
        run_session(w, truth_b)


@pytest.fixture(scope="module")
def merged(sessions):
    _, _, _, ga, gb = sessions
    return merge.merge_maps(ga, gb, range_max=RANGE_MAX,
                            score_threshold=-0.25, device="cpu")


def test_merge_recovers_alignment(sessions, merged):
    w, truth_a, truth_b, ga, gb = sessions
    res = merged
    assert res.pairs_accepted >= 2
    assert res.graph.num_scans == ga.num_scans + gb.num_scans
    # Cross constraints are switchable.
    assert int(res.graph.constraint_switchable.sum()) >= res.pairs_accepted
    # A's frame is anchored at truth_a[0], B's at truth_b[0].
    rel_b = metrics.relative_to_first(truth_b)
    t_true = compose(pose_ops.inverse(
        torch.tensor(truth_a[0], dtype=torch.float32)).numpy(), truth_b[0])
    assert np.hypot(*(res.transform[:2] - t_true[:2])) < 0.15
    assert angle_error(res.transform[2], t_true[2]) < 0.05
    # Merged B poses track B's ground truth expressed in A's frame.
    truth_b_in_a = np.asarray([compose(t_true, p) for p in rel_b])
    est_b = res.graph.poses[ga.num_scans:]
    assert metrics.ate_rmse(est_b, truth_b_in_a) < 0.2


def test_merge_matches_the_jax_merge(sessions, merged):
    """The JAX package merges the same two graphs to the same alignment."""
    _, _, _, ga, gb = sessions
    ref = jax_merge.merge_maps(ga, gb, range_max=RANGE_MAX,
                               score_threshold=-0.25)
    assert merged.pairs_checked == ref.pairs_checked
    assert merged.pairs_accepted >= 2 and ref.pairs_accepted >= 2
    assert np.hypot(*(merged.transform[:2] - ref.transform[:2])) < 0.05
    assert angle_error(merged.transform[2], ref.transform[2]) < 0.02
    assert merged.graph.num_constraints - merged.pairs_accepted \
        == ref.graph.num_constraints - ref.pairs_accepted
    np.testing.assert_allclose(merged.graph.poses[:ga.num_scans],
                               ref.graph.poses[:ga.num_scans], atol=0.05)


def test_merge_fails_cleanly_without_overlap(sessions):
    w, truth_a, truth_b, ga, gb = sessions
    # Session C maps the top corridor: no overlap with A's bottom run.
    n = 12
    truth_c = np.stack([np.linspace(12.0, 6.0, n),
                        np.full(n, 14.0), np.full(n, np.pi)], axis=-1)
    gc = run_session(world(), truth_c)
    with pytest.raises(ValueError):
        merge.merge_maps(ga, gc, range_max=RANGE_MAX, min_similarity=0.97,
                         score_threshold=-0.45, device="cpu")


def test_merge_rejects_mismatched_capacity(sessions):
    _, _, _, ga, _ = sessions
    small = Graph(max_points_per_scan=64)
    small.add_scan(np.zeros(3), np.zeros((64, 2), np.float32),
                   np.ones(64, bool))
    with pytest.raises(ValueError):
        merge.merge_maps(ga, small, range_max=RANGE_MAX, device="cpu")


def test_cli_merge_maps(sessions, merged, tmp_path, capsys):
    """``merge-maps`` loads two saved maps, merges them on the requested
    device and saves the fused graph."""
    import json

    from ndt_2d_tpu_torch import cli
    from ndt_2d_tpu_torch.io import serialization
    _, _, _, ga, gb = sessions
    a, b, out = (str(tmp_path / f) for f in ("a.npz", "b.npz", "ab.npz"))
    serialization.save_graph(ga, a)
    serialization.save_graph(gb, b)
    assert cli.main(["merge-maps", "--map-a", a, "--map-b", b, "--out", out,
                     "--max-range", str(RANGE_MAX), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["scans"] == ga.num_scans + gb.num_scans
    assert stats["cross_constraints"] == merged.pairs_accepted
    np.testing.assert_allclose(stats["transform_b_to_a"], merged.transform,
                               atol=1e-4)
    fused = serialization.load_graph(out, 512)
    assert fused.num_scans == stats["scans"]
    # No overlap: the verb reports the failure and exits 1.
    assert cli.main(["merge-maps", "--map-a", a, "--map-b", a, "--out", out,
                     "--max-range", str(RANGE_MAX), "--device", "cpu",
                     "--min-similarity", "1.5"]) == 1
    assert "error" in json.loads(capsys.readouterr().out.strip())

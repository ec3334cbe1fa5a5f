"""Whole port sessions with loop closure and optimization on the CPU twins.

The port maps the office ring of tests/test_mapper_e2e.py (drifting
odometry, a pass every 15 keyframes, optimization after 10 new nodes), as
the JAX package's test_optimization_reanchors_dead_reckoning does, and is
held to that test's criteria: at least one mid-session optimization, the
dead-reckoning anchor equal to the newest graph pose after every scan, and
a final ATE no worse than 1.10 x the online ATE.  The CLI runs a small
revisiting bag and confirms a closure.
"""

import dataclasses
import json

import numpy as np
import torch

from ndt_2d_tpu.utils import metrics
from ndt_2d_tpu_torch import cli
from ndt_2d_tpu_torch.mapping.mapper import Mapper

from test_torch_loop_closure import CFG, office_ring, scans

torch.set_num_threads(2)


def test_optimization_session_reanchors_and_keeps_ate():
    world, truth, odom = office_ring(trans_noise=0.02, rot_noise=0.004)
    cfg = dataclasses.replace(CFG, optimization_node_limit=10,
                              loop_closure_every=15,
                              loop_closure_region_size=2)
    mapper = Mapper(cfg, device="cpu")
    est, used_truth = [], []
    for t, (msg, o) in enumerate(zip(scans(world, truth), odom)):
        res = mapper.process_scan(msg, o)
        if res.accepted:
            est.append(res.pose)
            used_truth.append(truth[t])
            np.testing.assert_allclose(
                mapper.prev_robot_pose,
                mapper.graph.poses[mapper.graph.num_scans - 1])
    mapper.loop_closure()
    assert mapper.stats.optimizations >= 1
    assert mapper.stats.loop_closures_accepted >= 1
    online = metrics.ate_rmse(np.asarray(est), np.asarray(used_truth))
    final = metrics.ate_rmse(mapper.graph.poses[:len(used_truth)],
                             np.asarray(used_truth))
    assert final <= online * 1.10 + 1e-6, (online, final)
    assert mapper.stats.timer.count["optimize"] >= 1


def test_cli_run_confirms_a_closure(tmp_path, capsys):
    bag = str(tmp_path / "box.npz")
    assert cli.main(["simulate", "--world", "box", "--scans", "30",
                     "--beams", "600", "--out", bag]) == 0
    capsys.readouterr()
    assert cli.main([
        "run", "--bag", bag, "--device", "cpu",
        "--max-points-per-scan", "256",
        "--local_scan_matcher.grid_cells", "160",
        "--global_scan_matcher.grid_cells", "160",
        "--global_scan_matcher.ndt_resolution", "0.35",
        "--global_scan_matcher.search_linear_size", "0.15",
        "--global_scan_matcher.search_linear_resolution", "0.01",
        "--global_scan_matcher.search_angular_size", "0.05",
        "--global-search-size", "4.0", "--loop-closure-region-size", "3",
        "--optimization-node-limit", "10",
        "--robust-loss", "huber"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["scans_accepted"] == 30
    assert stats["loop_closures"] >= 1
    assert stats["graph_constraints"] == 29 + stats["loop_closures"]
    assert stats["session"]["optimizations"] >= 1
    assert stats["ate_rmse_m"] < 0.1

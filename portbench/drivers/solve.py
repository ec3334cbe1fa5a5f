"""Driver ``solve``: batch pose-graph optimization.

Set-up loads the traffic's ``graphs`` (graphs 0, 1, ... of the
configuration's ``graph`` object at its ``reference_seed``: the same set
for every run, since how many LM iterations a solve takes depends on its
graph, and a seed's own draw moved the window's rate by a fifth) into the
port's ``Graph``; they are made once and kept in the checkout's cache.
The window runs cycles, each every graph once in an order drawn from the
seed, one ``solve_graph`` call after another, each from the graph's
dead-reckoned poses, and closes at the end of the cycle in flight once its
seconds are up.  Every call's optimum is checked after the window (calls
that return the same bits are checked once).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from portbench import port, roofline
from portbench.reference import pose_graph as ref
from portbench.trace import Window
from portbench.traffic import city_graph


class State:
    pass


class Problem:
    """One graph: its data, the port's ``Graph`` of it, and the distinct
    optimums the window's calls returned."""

    def __init__(self, data: dict):
        from ndt_2d_tpu_torch.graph import pose_graph
        self.data = data
        self.graph = pose_graph.Graph(1)
        none = np.zeros((1, 2), np.float32)
        off = np.zeros(1, bool)
        for p in data["initial"]:
            self.graph.add_scan(p, none, off)
        for b, e, t, info in zip(data["begin"], data["end"],
                                 data["transform"], data["information"]):
            self.graph.add_constraint(int(b), int(e), t, info, False)
        self.outputs = {}

    def record(self) -> dict:
        d = self.data
        return {"poses_in": d["initial"], "begin": d["begin"],
                "end": d["end"], "transform": d["transform"],
                "information": d["information"],
                "switchable": np.zeros(len(d["begin"]), bool)}


def setup(ctx):
    spec = dict(ctx.config["graph"], **ctx.traffic.get("graph", {}))
    state = State()
    state.ctx = ctx
    base = int(spec["reference_seed"])
    state.problems = [Problem(city_graph.cached(spec, base, k, ctx.cache))
                      for k in range(int(ctx.traffic["graphs"]))]
    state.solver = port.solver_config(ctx.config["solver"])
    for p in state.problems:                # the warm calls
        solve_once(state, p)
        p.outputs = {}
    return state


def solve_once(state, p: Problem) -> None:
    from ndt_2d_tpu_torch.graph import solver
    p.graph.set_poses(p.data["initial"])
    ok = solver.solve_graph(p.graph, state.solver, device=state.ctx.device)
    poses = p.graph.poses
    key = hashlib.sha256(poses.tobytes()).hexdigest()
    if key not in p.outputs:
        p.outputs[key] = (poses.copy(), bool(ok))


def window(state, seconds: float, rec) -> None:
    ctx = state.ctx
    calls = 0
    order = np.random.default_rng([ctx.seed % (1 << 63), 6])
    before = port.launch_counts()
    with Window(ctx.traced, ctx.device) as w:
        deadline = time.perf_counter() + seconds
        while True:
            for k in order.permutation(len(state.problems)).tolist():
                solve_once(state, state.problems[k])
                calls += 1
            if time.perf_counter() >= deadline:
                break
    rec.launches = port.launches_since(before)
    rec.window_s = w.seconds
    rec.trace = w.summary
    rec.counts = {"solves": calls, "attempted": calls, "failed": 0}
    d = state.problems[0].data
    rec.extra["pcg_bytes"] = roofline.pcg_solve_bytes(len(d["initial"]),
                                                      len(d["begin"]))


def check(state, control: bool = False) -> list:
    """``node_step`` of every distinct optimum of the window; with
    ``control`` of the TF32 reference's optimum of each graph in the
    program's place."""
    import torch
    ctx = state.ctx
    for p in state.problems:
        p.graph = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    solver = port.as_dict(state.solver)
    steps = []
    for p in state.problems:
        if control:
            steps.append(ref.solve_step(p.record(), solver, ctx.device,
                                        control=True))
            continue
        steps += [ref.node_step(p.record(), poses, solver, ctx.device)
                  for poses, _ in p.outputs.values()]
        if not p.outputs:
            steps.append(float("inf"))
    return [{"name": "solve_step", "value": max(steps),
             "limit": ctx.traffic["limits"]["solve_step"]}]

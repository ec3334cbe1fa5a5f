"""The generator makes the city cell's graphs as stated."""

import json
import os

import numpy as np
import pytest

import portbench_cells as cells
from portbench.traffic import city_graph


def config(name):
    with open(os.path.join(cells.BENCH, "configs", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_city_graph_has_city10000s_counts(seed):
    spec = config("city10k")["graph"]
    g = city_graph.graph(spec, seed)
    n = g["initial"].shape[0]
    assert n == 10_000 and g["truth"].shape == (n, 3)
    assert len(g["begin"]) == 20_687
    odo = slice(0, n - 1)
    assert np.array_equal(g["begin"][odo], np.arange(n - 1))
    assert np.array_equal(g["end"][odo], np.arange(1, n))
    b, e = g["begin"][n - 1:], g["end"][n - 1:]
    assert len(b) == 10_688 and (e - b >= spec["closure_min_gap"]).all()
    assert np.array_equal(g["truth"][b, :2], g["truth"][e, :2])
    assert len(set(zip(b.tolist(), e.tolist()))) == len(b)
    again = city_graph.graph(spec, seed)
    assert all(np.array_equal(g[k], again[k]) for k in g)
    other = city_graph.graph(spec, seed, 1)
    assert not np.array_equal(g["truth"], other["truth"])
    assert len(other["begin"]) == 20_687


def test_city_graph_is_made_once_into_the_cache(tmp_path):
    with open(os.path.join(cells.HERE, "data", "city_tiny.json")) as fh:
        spec = json.load(fh)["graph"]
    made = city_graph.cached(spec, 3, 1, str(tmp_path))
    assert os.listdir(tmp_path) and len(os.listdir(tmp_path)) == 1
    again = city_graph.cached(spec, 3, 1, str(tmp_path))
    direct = city_graph.graph(spec, 3, 1)
    assert all(np.array_equal(made[k], direct[k]) for k in direct)
    assert all(np.array_equal(again[k], direct[k]) for k in direct)

"""No run loads JAX or the JAX package; the reference loads nothing of
the program."""

import subprocess
import sys
import types

import portbench_cells as cells
from portbench import guard


def test_guard_compares_top_level_names_whole(monkeypatch):
    assert guard.forbidden_modules() == []
    for name in ("ndt_2d_tpu_torch_x", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert guard.forbidden_modules() == []
    for name in ("ndt_2d_tpu.config", "jax._src"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert guard.forbidden_modules() == ["jax", "ndt_2d_tpu"]


def _loaded(code: str) -> set:
    """Top-level names of the modules loaded after running ``code``."""
    tail = ("\nimport sys\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code + tail], cwd=cells.REPO,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    return set(eval(r.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    names = _loaded(
        "import sys, os; sys.path.insert(0, '.')\n"
        "from portbench import bench\n"
        "b = bench.Bench('.')\n"
        "for w in b.manifest['workloads']:\n"
        "    bench.Context(b, w['name'], 1, None, False)\n"
        "for m in b.manifest['end_to_end'] + b.manifest['per_layer']:\n"
        "    b.metric(m['name'])\n"
        "import ndt_2d_tpu_torch.mapping.mapper\n"
        "import ndt_2d_tpu_torch.graph.solver")
    assert "ndt_2d_tpu_torch" in names
    assert not names & set(guard.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.reference.pose_graph\n"
        "import portbench.traffic.city_graph, portbench.roofline")
    assert not names & (set(guard.FORBIDDEN) | {"ndt_2d_tpu_torch"})

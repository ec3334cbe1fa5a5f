"""The port's entry points (``ndt_2d_tpu_torch/entry.py``) against the JAX
package's driver entry points (``__graft_entry__.py``).

``entry()``: the same flagship inputs through the port's K1 + K2 twins and
through JAX's jitted forward at the decision level (XLA contracts FMAs,
which moves the lattice by an ulp and this fixture's score by 2.3e-5): the
correction within 1e-6 and the score within 1e-4.  The same fixture
against op-by-op JAX, candidate by candidate: tests/test_torch_matcher.py.
``dryrun_multichip`` on 2 and 4 gloo ranks (one torch thread a rank,
tests/torch_blocks_ranks.py): it passes on every rank, every rank holds
the same bits, no rank imports JAX.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from ndt_2d_tpu_torch import entry

import torch_blocks_ranks as ranks

torch.set_num_threads(2)


def test_entry_matches_jax_decision():
    fn, args = entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args
               if isinstance(a, torch.Tensor))
    got = fn(*args)
    jfn, jargs = jax_entry.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(got.score) < -0.5
    jit = jax.jit(jfn)(*jargs)
    np.testing.assert_allclose(got.correction.numpy(),
                               np.asarray(jit.correction), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.score), float(jit.score), rtol=1e-4)


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    out = {}
    for n, shape in ((2, (2, 1)), (4, (2, 2))):
        d = str(tmp_path_factory.mktemp(f"dryrun{n}"))
        out[n] = ranks.run_ranks("dryrun", d, *shape)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_ranks(dryruns, n):
    runs = dryruns[n]
    assert len(runs) == n
    for res in runs:
        assert not bool(res["imported_reference"])
        for k in ("mapper_poses", "slam_poses", "blocks_score",
                  "search_idx", "weights"):
            np.testing.assert_array_equal(res[k], runs[0][k], err_msg=k)
    assert runs[0]["weights"].shape == (8 * (n // 2),)

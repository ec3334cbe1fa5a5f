"""test_office_loop_matches_single_device's descriptor arm
(tests/test_mesh_mapper.py:63-97) on the port: the office ring of
tests/test_torch_mesh_office.py with descriptor loop search (K10's search
sharded over the query rows, far rows coarse-to-fine) on a (1, 2) gloo
mesh, where the confirmation rows shard over the batch axis, held to the
same criteria.
"""

import torch

from test_torch_mesh_office import check_office
from test_torch_mesh_sessions import _beside
import torch_mesh_ranks as ranks

torch.set_num_threads(2)


def test_office_loop_matches_single_device_descriptor(tmp_path):
    check_office(*_beside("office", (1, 2), tmp_path, "descriptor",
                          lambda: ranks.office_session("descriptor")))

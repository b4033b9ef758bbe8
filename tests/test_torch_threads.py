"""The root ``conftest.py`` runs every test process's torch on one thread.

This file has no fixture of its own, so what it sees is what every port
test sees: a file that forgets to pin torch still runs on one thread.
"""

import torch


def test_a_port_test_runs_torch_on_one_thread():
    assert torch.get_num_threads() == 1

"""Every test process runs torch on one thread: six test workers, each with
torch's default of a thread per core, oversubscribe the host many times over.

``tests/conftest.py`` sets JAX's flags before JAX's first import; this file
imports no JAX. Subprocesses that tests start pin themselves.
"""


def pytest_configure():
    import torch

    torch.set_num_threads(1)

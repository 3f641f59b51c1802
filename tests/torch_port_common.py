"""What the port's test files (tests/test_torch_*.py) share.

`one_torch_thread`: a test module that imports it runs torch at one
intra-op thread (pytest registers an imported fixture as the module's
own): the test workers share the host's cores, and torch's own threads
only spin against the other workers.

`executor(pkg)`: one executor a package for the test process, so that
the JAX executor's compile cache (an LRU) serves every test; the port's
runs on the CPU.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_EXE = {}


def executor(pkg):
    if pkg not in _EXE:
        torch_port = pkg.__name__ == "paddle_tpu_torch"
        _EXE[pkg] = (pkg.Executor(pkg.CPUPlace()) if torch_port
                     else pkg.Executor())
    return _EXE[pkg]

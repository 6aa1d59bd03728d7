"""One torch thread for the tests of gyroflow_torch that import this fixture.

The tier-1 run puts six pytest workers on the machine's cores. Each torch
op with intra-op threads then starts as many threads as there are cores in
every worker, and the workers' thread pools wait on one another: the probes
of ``experiments.run_all(small=True)`` take ~3 s alone and stall for minutes
in that run. The port's CPU tests run at small sizes, where one thread costs
little. The setting lasts for the importing module and is then restored.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

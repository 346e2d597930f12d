"""One intra-op thread for the port's tests.

The suite runs in several worker processes at once (``pytest -n``), each of
which would otherwise give torch every core of the machine: the workers'
thread pools then contend for the same cores, and a reduced model's small
ops spend most of their time waiting on each other.  A port test module
imports ``one_torch_thread`` (an autouse fixture: its tests' torch ops run
on one thread, restored after the module; gloo ranks spawned with the
default ``threads`` share that one out) and passes ``cli_env()`` to the
launcher subprocesses it starts.
"""
import os

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cli_env(**extra) -> dict:
    """The environment of a launcher subprocess: the port on its path, one
    intra-op thread (``OMP_NUM_THREADS``)."""
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", **extra)

"""A cap on PyTorch's CPU threads in the port's CPU test files.

The repo's test command runs the tests in 6 pytest-xdist workers on one
host.  Each worker's PyTorch would start one intra-op thread per core, and
six oversubscribed pools spin against each other (on an 8-core host the
port's CPU test files took about three times as long uncapped as at 2
threads each).  Every port test file that runs PyTorch on the CPU imports
`torch_threads`, an autouse
module fixture that sets TEST_THREADS for the file's tests and restores the
count after them (the thread count changes only the order of float32 sums,
which every tolerance of those files allows for)."""

import ast
from pathlib import Path

import pytest
import torch

TEST_THREADS = 2
TESTS = Path(__file__).resolve().parent
# the port's test files that run no PyTorch on the CPU in this process
UNCAPPED = {"test_torch_port_gpu.py", "test_torch_port_imports.py", Path(__file__).name}


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(before)


def test_cap_is_in_effect():
    assert torch.get_num_threads() == TEST_THREADS


@pytest.mark.parametrize("name", sorted(p.name for p in TESTS.glob("test_torch_port_*.py")
                                        if p.name not in UNCAPPED))
def test_port_file_caps_torch_threads(name):
    tree = ast.parse((TESTS / name).read_text())
    imported = {(n.module, a.name) for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                for a in n.names}
    assert ("tests.test_torch_port_threads", "torch_threads") in imported

"""The benchmark's CPU tests run torch at two threads."""

import pytest
import torch

import bench_support  # noqa: F401  (puts the benchmark on the import path)


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

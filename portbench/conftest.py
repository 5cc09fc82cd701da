"""Shared by every test of the benchmark.

The grep cell's small sizes, beside the word count's in
``tests/conftest.py``: 20,000 records (two of them matching, 2,040,000
bytes) instead of the node's 5,600,000.  And an empty metrics registry for each test: the
``host_syncs`` readers read the process registry, which the runs of
other tests (other cells' jobs among them) would otherwise have counted
into."""

import pytest

from portbench.tests import conftest

conftest.SMALL.setdefault("grep-pavlo", {"records": 20_000,
                                         "bytes": 20_000 * 102})


@pytest.fixture(autouse=True)
def _fresh_registry():
    from mapreduce_tpu_torch.obs import registry

    registry.get_registry().reset()
    yield

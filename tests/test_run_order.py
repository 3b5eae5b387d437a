"""The order the repo's root ``conftest.py`` gives an xdist run's files."""

import importlib.util
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def order():
    # loaded by path: ``import conftest`` would find this directory's own
    spec = importlib.util.spec_from_file_location(
        "root_conftest", REPO / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ordered(order, ids, workers=None):
    items = [types.SimpleNamespace(nodeid=i) for i in ids]
    config = types.SimpleNamespace(
        option=types.SimpleNamespace(loadscopereorder=True))
    if workers:
        config.workerinput = {"workerid": "gw0", "workercount": workers}
    order.pytest_configure(config)
    assert config.option.loadscopereorder is False
    order.pytest_collection_modifyitems(config, items)
    return [i.nodeid for i in items]


def test_long_files_first_then_most_tests_first(order):
    first, second, third = list(order.LONG)[:3]
    ids = ["tests/a.py::t1", "tests/a.py::t2",
           "tests/b.py::t1", "tests/b.py::t2[x]", "tests/b.py::t2[y]",
           f"{third}::t", f"{second}::t",
           f"{first}::test_dryrun_multichip_hermetic_to_cpu",
           f"{first}::test_dryrun_multihost",
           "tests/c.py::t"]
    long = [f"{first}::test_dryrun_multichip_hermetic_to_cpu",
            f"{first}::test_dryrun_multihost", f"{second}::t", f"{third}::t"]
    rest = ["tests/b.py::t1", "tests/b.py::t2[x]", "tests/b.py::t2[y]",
            "tests/a.py::t1", "tests/a.py::t2", "tests/c.py::t"]
    assert _ordered(order, ids, workers=6) == long + rest
    # with fewer workers than long files, the first file after them moves
    # to the place after the first one a worker
    assert _ordered(order, ids, workers=2) == (
        long[:3] + rest[:3] + long[3:] + rest[3:])
    # outside xdist's workers pytest's own order stays
    assert _ordered(order, ids) == ids


def test_long_files_exist_longest_first(order):
    assert list(order.LONG.values()) == sorted(order.LONG.values(),
                                               reverse=True)
    for path in order.LONG:
        assert (REPO / path).is_file(), path

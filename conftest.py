"""The order in which an xdist run hands out test files.

Under ``--dist loadfile`` a worker runs one file at a time, and xdist hands
files out most-tests-first. A file of few but long tests therefore starts
last and becomes the run's tail: ``tests/test_graft_entry.py`` has two
tests, 149-214 s and 292-671 s, and started when the rest of a 1,295 s
run was nearly done (an 8-core host, 6 workers).

Here the files of :data:`LONG` are handed out first, longest first, and
every other file after them, most tests first, as xdist would. One file
moves: a worker whose file has two tests or fewer is handed the next file
at once, so the file after the first one a worker shares its worker with
``tests/test_graft_entry.py``'s two. That place goes to the first file
after :data:`LONG` (the one of most tests, about a second), not to a file
of a few minutes.

Nothing here selects or changes a test, and a run without xdist keeps
pytest's own order.
"""

# seconds each file took in a tier-1 run (8-core host, 6 workers), longest
# first
LONG = {
    "tests/test_graft_entry.py": 640.5,
    "tests/test_multidevice_train.py": 500.2,
    "tests/test_inference.py": 320.6,
    "tests/test_cli.py": 272.6,
    "tests/test_train.py": 249.8,
    "tests/test_torch_dp.py": 181.1,
    "tests/test_grad_accum.py": 174.5,
    "tests/test_torch_deeplab.py": 173.0,
    "tests/test_torch_export.py": 161.4,
    "tests/test_torch_spatial.py": 148.2,
    "tests/test_multistep.py": 138.4,
    "tests/test_pallas_swin.py": 129.1,
    "tests/test_models.py": 123.6,
}


def pytest_configure(config):
    # the controller: hand out files in the order the workers collected
    # them (below) instead of most-tests-first
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    if not hasattr(config, "workerinput"):    # not an xdist worker
        return
    counts = {}
    for item in items:
        path = item.nodeid.split("::", 1)[0]
        counts[path] = counts.get(path, 0) + 1
    long = [path for path in LONG if path in counts]
    rest = sorted((path for path in counts if path not in LONG),
                  key=lambda path: -counts[path])
    order = long + rest
    workers = config.workerinput["workercount"]
    if rest and len(long) > workers:
        order.insert(workers, order.pop(len(long)))
    rank = {path: i for i, path in enumerate(order)}
    items.sort(key=lambda item: rank[item.nodeid.split("::", 1)[0]])

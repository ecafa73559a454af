"""Repository-wide pytest settings: how xdist hands out the tier-1 tests.

Under the tier-1 command's ``--dist loadfile`` a test file is one worker's
job, so the slowest file bounds the run's wall time. No unit of work should
sum over about 300 s on CPU: split a port test file before it gets there.
The JAX package's own test files stay as they are; those that are longer are
named in ``SPLIT_BY_CASE`` and handed out one test case at a time, so their
cases run on several workers.
"""

SPLIT_BY_CASE = ('tests/test_planar.py',)


def pytest_xdist_make_scheduler(config, log):
    if config.getvalue('dist') != 'loadfile':
        return None
    from xdist.scheduler import LoadFileScheduling

    class FileOrCaseScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = nodeid.split('::', 1)[0]
            return nodeid if path in SPLIT_BY_CASE else path

    return FileOrCaseScheduling(config, log)

"""The benchmark's own tests (CPU; one needs the H100 and skips without it):
``python -m pytest port_bench/tests -q``. Each file's name starts with
``test_port_bench_``, which the program's ``tests/`` does not use."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA H100; decides inside the test "
                                       "and skips on a machine without one")

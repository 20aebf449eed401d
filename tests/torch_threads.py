"""A cap on torch's CPU threads around a test's whole fit.

A fit on the CPU is thousands of small ops, each a parallel region over
torch's threads (one a core by default).  Under the test runner's several
workers, each with that many threads, the regions wait on one another and
a fit that takes 18 s alone took 347 s; two threads a fit keep it near its
time alone.  The results the tests check (accuracy and recall bars) do not
depend on the thread count."""
import contextlib

import torch


@contextlib.contextmanager
def few_threads(n: int = 2):
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)

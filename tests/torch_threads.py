"""Imported by the port's test files for its side effect: torch runs each
test process's CPU operators on one thread.

pytest-xdist runs several test processes on the machine's cores, and torch
gives each process one intra-op thread a core by default. The cores are then
oversubscribed, and the tests' small operators spend their time handing work
between threads: milliseconds an operator where one thread takes tens of
microseconds. JAX's thread pools are not changed.
"""

import torch

torch.set_num_threads(1)

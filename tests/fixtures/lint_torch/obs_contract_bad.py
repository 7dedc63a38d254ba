"""Fixture: raw clock reads outside repro_torch.obs.  obs-contract must
flag the three marked calls and leave time.monotonic alone."""
import time
from time import perf_counter as pc


def measure():
    t0 = time.perf_counter()  # BAD
    wall = time.time()  # BAD
    return wall - t0, pc(), time.monotonic()  # BAD: pc()

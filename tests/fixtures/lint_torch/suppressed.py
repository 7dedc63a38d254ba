"""Fixture: suppression semantics.  Line A is silenced by a justified
disable; line B carries a disable without a justification (itself a
finding, pass id "suppression"); line C is a plain finding."""
import time


def clocks():
    a = time.time()  # lint: disable=obs-contract -- a fixture's justified read
    b = time.time()  # lint: disable=obs-contract
    c = time.time()
    return a, b, c

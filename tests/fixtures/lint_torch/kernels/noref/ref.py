"""Fixture: a kernel package whose ref.py has no public *_ref plain
version.  kernel-shape's static layer must flag it."""


def _noref_ref(x):
    return x

"""Named lock factories for every lock of the serving stack.

The port of ``kdtree_tpu/analysis/lockwatch.py``'s factory surface: each
lock is made through a dotted role name (``"serve.admission"``), so a
runtime lock-order sanitizer can later instrument all of them at one
place. Until then they return the plain stdlib primitives. The sanitizer
itself is ROADMAP item 18.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A non-reentrant mutex for the role ``name``."""
    return threading.Lock()


def make_rlock(name: str):
    """A reentrant mutex: for state a signal handler may re-enter."""
    return threading.RLock()


def make_condition(name: str):
    """A ``threading.Condition``. Like the stdlib's default it is backed by
    an RLock, so a sanitizer that wraps it later keeps its reentrancy."""
    return threading.Condition(threading.RLock())

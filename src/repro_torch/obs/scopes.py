"""Named scopes for the dispatch-level cost count (the port's
`jax.named_scope`, read by `launch.hlo_cost`).

`scope(name)` tags the ops this thread dispatches inside the block with
`name`; scopes nest. The kernels' autograd Functions and the models'
attention calls open one, so this module imports nothing but the standard
library.

Outside a count a scope costs nothing on the serving path: `scope` hands
back one shared no-op context manager unless `counting()` is open (as
`launch.hlo_cost.run_counted` opens it), and pushes no name.
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()
_COUNTING = [0]  # the counts now open, in any thread


class _NullScope:
    """The shared no-op context manager `scope` returns outside a count."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SCOPE = _NullScope()


class _Scope:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_STATE, "stack", None)
        if stack is None:
            stack = _STATE.stack = []
        stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False


def scope(name: str):
    """Tag the ops this thread dispatches inside the block with `name` while
    a count is open; a shared no-op otherwise."""
    return _Scope(name) if _COUNTING[0] else _NULL_SCOPE


def open_scopes() -> list:
    """The names of the scopes open in this thread, outermost first."""
    return getattr(_STATE, "stack", [])


@contextlib.contextmanager
def counting():
    """Make `scope` record names for the block (counts nest)."""
    _COUNTING[0] += 1
    try:
        yield
    finally:
        _COUNTING[0] -= 1

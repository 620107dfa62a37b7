"""libfaketime wrappers — per-process clock rates and offsets.

Reference: jepsen/src/jepsen/faketime.clj — replaces a db binary with a
script that runs the original under ``faketime`` so a single process
experiences a skewed or fast/slow clock (script at faketime.clj:8-18,
idempotent wrap! at 20-31).
"""

from __future__ import annotations

from . import control
from .control import lit


def script(cmd: str, init_offset: int, rate: float) -> str:
    """The wrapper script body (faketime.clj:8-18)."""
    sign = "-" if init_offset < 0 else "+"
    return ("#!/bin/bash\n"
            f'faketime -m -f "{sign}{abs(int(init_offset))}s x{rate:g}" '
            f'{cmd} "$@"')


def wrap(sess: control.Session, cmd: str, init_offset: int,
         rate: float) -> None:
    """Replace cmd with a faketime wrapper; original moves to
    cmd.no-faketime.  Idempotent (faketime.clj:20-31)."""
    from . import control_util as cu

    moved = f"{cmd}.no-faketime"
    wrapper = script(moved, init_offset, rate)
    if cu.exists(sess, moved):
        sess.exec("echo", wrapper, lit(">"), cmd)
    else:
        sess.exec("mv", cmd, moved)
        sess.exec("echo", wrapper, lit(">"), cmd)
        sess.exec("chmod", "a+x", cmd)


def unwrap(sess: control.Session, cmd: str) -> bool:
    """Undo :func:`wrap`: restore the original binary over the wrapper
    script.  Idempotent — unwrapping a never-wrapped (or already
    unwrapped) cmd is a no-op.  Returns whether a wrapper was removed."""
    from . import control_util as cu

    moved = f"{cmd}.no-faketime"
    if not cu.exists(sess, moved):
        return False
    sess.exec("mv", "-f", moved, cmd)
    return True


def wrapped(sess: control.Session, cmd: str) -> bool:
    """Is cmd currently a faketime wrapper? (the .no-faketime original
    exists exactly while wrapped)"""
    from . import control_util as cu

    return cu.exists(sess, f"{cmd}.no-faketime")

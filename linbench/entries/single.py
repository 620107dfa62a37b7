"""Entry ``single``: one Jepsen history checked by
``linearizable(model=cas_register()).check(test, history)``, the
checker a suite builds with no arguments."""

from __future__ import annotations


def build():
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import cas_register

    return linearizable(model=cas_register())


def to_program(events) -> list:
    from jepsen_tpu_torch.history import Op

    return [Op(process=e[0], type=e[1], f=e[2], value=e[3])
            for e in events]


def verdicts(result: dict) -> dict:
    """The history's verdict, under the key None."""
    return {None: result.get("valid")}


def engines(result: dict) -> dict:
    """The engine that decided the history, under the key None."""
    return {None: result.get("engine")}

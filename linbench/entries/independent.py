"""Entry ``independent``: a keyed Jepsen test checked by
``independent.checker(linearizable(model=cas_register()))``, the
checker a suite builds with no arguments, one ``.check(test, history)``
per stored test."""

from __future__ import annotations


def build():
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import cas_register

    return independent.checker(linearizable(model=cas_register()))


def to_program(events) -> list:
    """The port's ops, values of keyed events as ``[k v]`` tuples."""
    from jepsen_tpu_torch.history import Op
    from jepsen_tpu_torch.independent import tuple_

    return [Op(process=e[0], type=e[1], f=e[2],
               value=tuple_(e[4], e[3]) if len(e) > 4 else e[3])
            for e in events]


def verdicts(result: dict) -> dict:
    """Each key's verdict, by key."""
    return {k: r.get("valid") for k, r in result.get("results", {}).items()}


def engines(result: dict) -> dict:
    """The engine that decided each key, by key."""
    return {k: r.get("engine") for k, r in result.get("results", {}).items()}

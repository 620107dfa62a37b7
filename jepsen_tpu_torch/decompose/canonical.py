"""Canonical forms of (sub-)histories; so far only the event ranks."""

from __future__ import annotations

from ..history import INF_RET


def event_ranks(inv, ret) -> tuple[list[int], list[int]]:
    """Dense ranks of a (sub-)history's own events; INF stays INF.

    The engines compare ``inv``/``ret`` by order only, so re-ranking
    changes no verdict."""
    inv = [int(x) for x in inv]
    ret = [int(x) for x in ret]
    events = sorted(set(inv) | {r for r in ret if r != INF_RET})
    rank = {e: i for i, e in enumerate(events)}
    return ([rank[i] for i in inv],
            [rank[r] if r != INF_RET else INF_RET for r in ret])

"""The fleet tier: a routed multi-worker checking service.

One router (``router.py``) spreads run namespaces over N
``stream.service`` workers by rendezvous hashing, probes their health
on ``reconnect.Backoff`` schedules, and reroutes a dead worker's runs
after salvaging their persisted verdicts.  Workers share one
verdict-cache store through per-worker write-ahead segments
(``cachestore.py``), warm their steady-state slice functions before
admission (``warmup.py``: on the card that builds B1 and launches it at
every shape), and an admission controller turns shed rate, open runs
and fold backlog into accept, shed or spawn-worker (``admission.py``).

``python -m jepsen_tpu_torch.fleet`` runs the tier (its workers are
``python -m jepsen_tpu_torch.stream`` processes, folding on ``--device``);
``bench.py`` drives a client swarm at an in-process tier.  The
counterpart of the JAX package's ``fleet/``.
"""

from .admission import AdmissionController, AdmissionPolicy  # noqa: F401
from .cachestore import FleetCacheStore  # noqa: F401
from .router import (  # noqa: F401
    FleetRouter,
    WorkerSpec,
    route_run,
)

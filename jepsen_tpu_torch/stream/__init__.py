"""Streaming checking: live verdicts while the test runs.

Everything else in the port checks after the fact.  This package turns
the quiescence cuts of ``decompose/`` (segments compose through their
reachable-state sets, P-compositionality, arXiv:1504.00204) into an
online checker:

  * :mod:`.checker`: :class:`StreamChecker`, the op sink (event pairing,
    online per-cell cuts, each closed segment folded the moment it
    closes, a live provisional verdict), and :class:`TotalFoldStream`,
    the multiset families' sink;
  * :mod:`.device`: wide segment folds on the batched device engine
    through state-pinning pseudo-ops (the kernel's grid over keys on
    the card);
  * :mod:`.service` and ``python -m jepsen_tpu_torch.stream``: a
    long-running service multiplexing history JSONL from many runs
    over stdin or a socket, all on one verdict cache;
  * :mod:`.bench`: the streaming bench tier (time to first verdict,
    violation-detection latency, multiplexed ingest).

The counterpart of the JAX package's ``stream/``.  Every entry point
takes ``device`` (``"cuda"`` by default); the routing rules live in
``analyze.plan`` (``segment_fold_route``, ``stream_plan``).
"""

from .checker import StreamChecker, TotalFoldStream
from .service import StreamService

__all__ = ["StreamChecker", "StreamService", "TotalFoldStream"]

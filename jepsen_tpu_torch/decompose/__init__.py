"""P-compositional history decomposition (Horn and Kroening,
arXiv:1504.00204): split one history into sub-histories that are far
cheaper to check apart, without changing the verdict.

  * :mod:`partition`: per-key locality splits, the exact per-value block
    decomposition of unique-write registers, and quiescence cuts;
  * :mod:`canonical`: sub-histories canonicalized and hashed, so equal
    shapes are recognized across keys and runs;
  * :mod:`cache`: the canonical-hash verdict cache, persisted under the
    store tree;
  * :mod:`engine`: the decomposed checker, cache -> partition ->
    sub-search, with a ``direct`` fallback;
  * :mod:`schedule`: independent cells over a host process pool or one
    device batch, largest first.

Every search entry point takes it as ``decompose=`` (off by default):
``checker/seq.py``, ``checker/linear.py``, and ``search_batch`` and
``Linearizable`` in ``checker/linearizable.py``.
"""

from .cache import VerdictCache, default_cache_path
from .canonical import canonical_key
from .engine import check_opseq_decomposed
from .partition import (partition_by_key, quiescence_segments, subseq,
                        value_block_verdict)

__all__ = [
    "VerdictCache",
    "default_cache_path",
    "canonical_key",
    "check_opseq_decomposed",
    "partition_by_key",
    "quiescence_segments",
    "subseq",
    "value_block_verdict",
]

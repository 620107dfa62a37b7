"""The live harness: the in-process daemons and the regression corpus.
The counterpart of the JAX package's ``jepsen_tpu.live``, so far its
daemons and its corpus:

  oplog.py             :class:`DurableLog`, the fsync'd oplog the
                       daemons share.
  kv_server.py         an etcd-v2-shaped KV/CAS node.
  queue_server.py      a disque-shaped RESP job queue node.
  replicated_server.py one replica of a 3-node leader-lease KV group.
  replicated_queue.py  one replica of the replicated RESP queue.
  corpus.py            the corpus of banked histories and its replay
                       through every engine route.

Exports resolve lazily: every daemon (``python -m
jepsen_tpu_torch.live.kv_server`` ...) imports this package on startup,
and an eager import of the corpus here would load numpy, torch and the
checker stack into each of them.
"""

_EXPORTS = {name: "corpus" for name in (
    "attach_minimal", "bank", "bank_cell", "corpus_dir", "corpus_replay",
    "entries_from_test", "entry_model", "load_pool", "replay_queue")}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)

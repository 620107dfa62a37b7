"""Live fault-injection campaigns: real processes, real faults.
The counterpart of the JAX package's ``jepsen_tpu.live``:

  backend.py           :class:`LiveBackend`: a real OS process per
                       logical node (launcher script and
                       start-stop-daemon), health checks with bounded
                       backoff, the family's wire protocol through the
                       suites' own clients, crash recovery from durable
                       oplogs.  Seven families (:data:`FAMILIES`).
  links.py             per-node loopback addresses, the crash-safe rule
                       journal, the iptables and tc rule engines and the
                       per-peer-link partition nemesis.
  matrix.py            the nemesis matrix: kill -9 and restart, SIGSTOP
                       pause, faketime clock skew, port partitions,
                       faultfs disk faults and the link grudges, each
                       with a probe that yields a skip reason.
  campaign.py          the family x nemesis campaign: every cell a whole
                       ``core.run`` with the streaming checker and the
                       certificate audit on, recorded with its
                       detection latency and recovery time under
                       ``store/campaigns/``.
  __main__.py          ``python -m jepsen_tpu_torch.live``.
  oplog.py             :class:`DurableLog`, the fsync'd oplog the
                       daemons share.
  kv_server.py         an etcd-v2-shaped KV/CAS node.
  queue_server.py      a disque-shaped RESP job queue node.
  replicated_server.py one replica of a 3-node leader-lease KV group.
  replicated_queue.py  one replica of the replicated RESP queue.
  pgwire_server.py     the pgwire shim's server as a process, its
                       committed register writes journalled.
  corpus.py            the corpus of banked histories and its replay
                       through every engine route.

Exports resolve lazily: every daemon (``python -m
jepsen_tpu_torch.live.kv_server`` ...) imports this package on startup,
and an eager import of the campaign or the corpus here would load numpy,
torch and the checker stack into each of them.
"""

_EXPORTS = {name: "corpus" for name in (
    "attach_minimal", "bank", "bank_cell", "corpus_dir", "corpus_replay",
    "entries_from_test", "entry_model", "load_pool", "replay_queue")} | {
    "FAMILIES": "backend", "LiveBackend": "backend",
    "ProcessDB": "backend",
    "plan": "campaign", "render_plan": "campaign",
    "run_campaign": "campaign", "run_cell": "campaign",
    "MatrixNemesis": "matrix", "standard_matrix": "matrix",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)

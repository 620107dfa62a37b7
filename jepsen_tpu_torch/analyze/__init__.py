"""Analyses around the checker, each a counterpart of the JAX package's
``jepsen_tpu.analyze``:

  * :mod:`.lint`: the well-formedness lint of event histories and
    encoded OpSeqs (H/M/Q codes); errors raise ``HistoryLintError``.
  * :mod:`.hb` and :mod:`.constraints`: the static prepass, which
    decides some histories with no search and otherwise yields
    must-order edges; :mod:`.dpor`: the reductions that act during the
    search.
  * :mod:`.plan`: the static plan (:func:`explain`,
    :func:`explain_batch`), which predicts what the engines would do
    without running them, and the applicability gates the engines
    consume.
  * :mod:`.audit`: the independent replay of a verdict's certificate
    (``audit.audit``).
  * :mod:`.shrink`: the delta-debugging of invalid histories, by rows
    of an OpSeq or by events.
  * :mod:`.modelcheck` and :mod:`.simnet`: the bounded model checker of
    the live daemons' state machines and of their request shells under
    a simulated transport (MC1xx, MC2xx), with schedule certificates.

:func:`analyze` runs the lint and the plan in one call; ``python -m
jepsen_tpu_torch.analyze`` is the command line over all of them.
"""

from __future__ import annotations

# ``audit`` stays the submodule's name here: the function is
# ``audit.audit``, which ``from jepsen_tpu_torch.analyze import audit``
# would otherwise shadow
from .audit import AUDIT_CODES, AuditError, audit_events  # noqa: F401
from .constraints import (MultisetFold, analyze_constraints,  # noqa: F401
                          analyze_prepass, analyze_queue_events,
                          analyze_set_events, family_of)
from .dpor import SleepSets, duplicate_op_edges, resolve_dpor  # noqa: F401
from .hb import (HBAnalysis, analyze_hb, hb_dispose,  # noqa: F401
                 hb_fold_states, maybe_hb, resolve_hb)
from .lint import (Diagnostic, HistoryLintError, HistoryScan,  # noqa: F401
                   lint_history, lint_opseq, scan_events)
from .plan import explain, explain_batch, render_plan  # noqa: F401
from .shrink import (brute_force_check, ddmin_list,  # noqa: F401
                     shrink_invalid, shrink_invalid_events)


def analyze(history, model=None, *, device="cuda") -> dict:
    """The lint and the plan in one call.

    ``history`` is an event list or an encoded OpSeq.  Returns
    ``{"diagnostics": [Diagnostic...], "errors": n, "warnings": n,
    "plan": {...} | None}``; the plan is computed only when a model is
    given and the lint found no error, for the search on ``device``."""
    from ..history import OpSeq

    if isinstance(history, OpSeq):
        diags = lint_opseq(history, model)
    else:
        diags = lint_history(history, model)
    errors = [d for d in diags if d.severity == "error"]
    plan = None
    if model is not None and not errors:
        plan = explain(history, model, device=device)
    return {"diagnostics": diags, "errors": len(errors),
            "warnings": len(diags) - len(errors), "plan": plan}

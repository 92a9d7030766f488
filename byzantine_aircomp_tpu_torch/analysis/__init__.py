"""Readers of the port's event stream and perf ledger.

The port's copies of the JAX package's stream readers
(``byzantine_aircomp_tpu/analysis/``): :mod:`.defense_trace`,
:mod:`.obs_report`, :mod:`.trace_view`, :mod:`.tail`, :mod:`.audit` and
:mod:`.perf_gate`.  Each prints for a port stream what its JAX twin prints
for the same stream, with no JAX installed::

    python -m byzantine_aircomp_tpu_torch.analysis obs_report runs/
    python -m byzantine_aircomp_tpu_torch.analysis.audit runs/x.events.jsonl --json
"""

READERS = ("obs_report", "defense_trace", "trace_view", "tail", "audit", "perf_gate")

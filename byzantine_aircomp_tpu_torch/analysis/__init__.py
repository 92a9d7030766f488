"""Readers of the port's event stream, perf ledger and run records.

The port's copies of the JAX package's readers
(``byzantine_aircomp_tpu/analysis/``): :mod:`.defense_trace`,
:mod:`.obs_report`, :mod:`.trace_view`, :mod:`.tail`, :mod:`.audit` and
:mod:`.perf_gate` print for a port stream what their JAX twins print for
the same stream, with no JAX installed; :mod:`.plots` draws the paper's
figure from pickled records and :mod:`.trajectory_plot` the trajectory
files; :mod:`.sweep` runs the (aggregator x attack) matrix,
:mod:`.fault_matrix` (aggregator x fault x attack), :mod:`.bits_matrix`
(sign-channel width x attack) and :mod:`.adaptive_matrix` (attack x
defense mode)::

    python -m byzantine_aircomp_tpu_torch.analysis obs_report runs/
    python -m byzantine_aircomp_tpu_torch.analysis plots --cache-dir recs --out fig.png
    python -m byzantine_aircomp_tpu_torch.analysis.audit runs/x.events.jsonl --json

The JAX package's ``python -m byzantine_aircomp_tpu.analysis`` draws the
figure with no reader name; here the reader is always named.
"""

READERS = ("obs_report", "defense_trace", "trace_view", "tail", "audit", "perf_gate",
           "plots", "fault_matrix", "bits_matrix", "adaptive_matrix")

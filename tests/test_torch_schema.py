"""The port's event schema against the JAX package's (schema v10): the
per-kind required fields, the reference-record key map and their golden
fingerprint (``tests/test_schema.py::GOLDEN``), the envelope
``make_event`` stamps, ``validate_event``'s verdicts, and the ``defense``
event.  Exact comparisons: the schema is data, copied verbatim."""

import pytest
from test_schema import GOLDEN, _fingerprint

from byzantine_aircomp_tpu.defense import events as jdefense_events
from byzantine_aircomp_tpu.obs import events as jevents
from byzantine_aircomp_tpu.obs import trace as jtrace
from byzantine_aircomp_tpu_torch.defense import events as tdefense_events
from byzantine_aircomp_tpu_torch.obs import MemorySink
from byzantine_aircomp_tpu_torch.obs import events as tevents
from byzantine_aircomp_tpu_torch.obs import trace as ttrace


def test_version_and_tables_are_the_jax_packages():
    assert tevents.SCHEMA_VERSION == jevents.SCHEMA_VERSION == 10
    assert tevents._REQUIRED == jevents._REQUIRED
    assert tevents.REFERENCE_KEY_MAP == jevents.REFERENCE_KEY_MAP


def test_fingerprint_is_the_golden_v10_row():
    got = _fingerprint(tevents._REQUIRED, tevents.REFERENCE_KEY_MAP)
    assert got == GOLDEN[10] == GOLDEN[tevents.SCHEMA_VERSION]


def test_defense_path_keys_agree_with_the_reference_map():
    for field, path in tdefense_events.PATH_KEYS.items():
        assert tevents.REFERENCE_KEY_MAP[field] == path
    assert tdefense_events.PATH_KEYS == jdefense_events.PATH_KEYS
    assert tdefense_events.METRIC_KEYS == jdefense_events.METRIC_KEYS


def _strip(event):
    return {k: v for k, v in event.items() if k != "ts"}


@pytest.mark.parametrize("traced", [False, True])
def test_make_event_stamps_the_jax_envelope(traced):
    fields = dict(round=3, val_loss=0.5, val_acc=0.9, variance=1e-3)
    if not traced:
        want, got = (jevents.make_event("round", **fields),
                     tevents.make_event("round", **fields))
    else:
        with jtrace.activate("a" * 32, "b" * 16):
            want = jevents.make_event("round", **fields)
        with ttrace.activate("a" * 32, "b" * 16):
            got = tevents.make_event("round", **fields)
        assert got["trace_id"] == "a" * 32 and got["span_id"] == "b" * 16
    assert _strip(got) == _strip(want)
    assert got["host_id"] == 0 and isinstance(got["ts"], float)


def _verdict(validate, event):
    try:
        validate(dict(event))
        return "ok"
    except ValueError:
        return "refused"


@pytest.mark.parametrize("kind", sorted(jevents._REQUIRED))
@pytest.mark.parametrize("drop", [None, 0])
def test_validate_event_agrees_with_jax(kind, drop):
    """Every kind, complete and with its first required field dropped."""
    fields = {f: 1 for f in jevents._REQUIRED[kind]}
    if drop is not None and fields:
        fields.pop(jevents._REQUIRED[kind][drop])
    event = tevents.make_event(kind, **fields)
    assert (_verdict(tevents.validate_event, event)
            == _verdict(jevents.validate_event, event))
    assert _verdict(tevents.validate_event, {**event, "v": 9}) == "refused"
    assert _verdict(tevents.validate_event, {k: v for k, v in event.items()
                                             if k != "kind"}) == "refused"


class _JaxObs:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append(jevents.make_event(kind, **fields))


@pytest.mark.parametrize("rung,prev", [(0, None), (1, 0), (0, 2), (2, 2)])
def test_emit_round_is_the_jax_defense_event(rung, prev):
    metrics = dict(rung=float(rung), flagged=2.0, suspicious_iters=1.0, score_max=3.5,
                   cusum_max=9.25, transitions=1.0)
    jobs, tobs = _JaxObs(), MemorySink()

    class _Obs:
        def emit(self, kind, **fields):
            tobs.emit(tevents.make_event(kind, **fields))

    jdefense_events.emit_round(jobs, 4, mode="adaptive", agg="mean", metrics=metrics,
                               prev_rung=prev)
    tdefense_events.emit_round(_Obs(), 4, mode="adaptive", agg="mean", metrics=metrics,
                               prev_rung=prev)
    got = {k: v for k, v in tobs.events[0].items() if k not in ("ts", "seq")}
    assert got == _strip(jobs.events[0])
    tevents.validate_event(tobs.events[0])

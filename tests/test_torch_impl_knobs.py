"""The implementation knobs of the port (``agg_impl``, ``fused_epilogue``,
``stack_dtype``, ``prng_impl``) against the JAX package on the CPU: fields,
flags, values and refusals; ``auto`` resolving to the plain versions on the
CPU and ``pallas`` refused there; every rule on one bf16 stack against the
JAX rule on the same bf16 stack; the channel fold on, off and auto; titles
and hashes.

Tolerances: the median, krum's row and the sign votes bitwise (the same
value is selected); the rest as the port's f32 tests of the same rule hold
them (gm2/gm rtol 1e-4 atol 1e-7, the mean rtol 1e-6, the trimmed mean
rtol 1e-5 atol 1e-6, bulyan and cclip atol 1e-6), since both sides upcast
the same bf16 values and sum in f32, in other orders.  Runs of the port
against itself (the fold on, off and auto) bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu import cli as jcli
from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu_torch import cli as tcli
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import graphs as tgraphs
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg
from byzantine_aircomp_tpu_torch.ops import kernels as tkernels

RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: small ops, and the bitwise run checks compare runs
    of one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=200)


# ---------------------------------------------------------------------------
# fields, flags, values, refusals

KNOBS = {"agg_impl": ("auto", ("auto", "xla", "pallas")),
         "fused_epilogue": ("auto", ("auto", "on", "off")),
         "stack_dtype": ("f32", ("f32", "bf16")),
         "prng_impl": ("threefry", ("threefry", "rbg", "unsafe_rbg"))}
# the JAX fields and run-parser flags the port has yet to port: none since
# the layout fields and the multi-process flags came
UNPORTED_FIELDS = set()
UNPORTED_FLAGS = set()


def test_fields_are_the_jax_fields_but_three():
    port = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxFedConfig)}
    assert len(jax_fields) == 109
    assert set(jax_fields) - set(port) == UNPORTED_FIELDS
    assert len(set(jax_fields) & set(port)) == 109
    assert set(port) - set(jax_fields) == {"use_gpu"}
    for name, (default, _) in KNOBS.items():
        assert port[name] == jax_fields[name] == default


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings if s.startswith("--")}


def test_run_parser_lacks_only_the_multi_device_flags():
    jax_flags, port_flags = _options(jcli.build_parser()), _options(tcli.build_parser())
    assert jax_flags - port_flags == UNPORTED_FLAGS
    assert port_flags - jax_flags == {"--device"}
    for flag in ("--backend", "--agg-impl", "--fused-epilogue", "--prng-impl",
                 "--stack-dtype", "--preset"):
        assert flag in port_flags


@pytest.mark.parametrize("field,value", [
    (f, v) for f, (_, values) in KNOBS.items() for v in values])
def test_each_value_parses_like_the_jax_cli(field, value):
    argv = ["--" + field.replace("_", "-"), value]
    port = tcli.config_from_args(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv), argv)
    assert getattr(port, field) == getattr(want, field) == value


@pytest.mark.parametrize("field,bad,match", [
    ("agg_impl", "triton", "agg_impl must be 'auto', 'xla' or 'pallas'"),
    ("fused_epilogue", "yes", "fused_epilogue must be 'auto', 'on' or 'off'"),
    ("stack_dtype", "f16", "stack_dtype must be 'f32' or 'bf16'"),
    ("prng_impl", "philox", "prng_impl must be 'threefry', 'rbg' or 'unsafe_rbg'"),
])
def test_bad_values_are_refused_with_the_jax_message(field, bad, match):
    with pytest.raises(ValueError, match=match):
        FedConfig(**{field: bad}).validate()
    with pytest.raises(AssertionError, match=match):
        JaxFedConfig(**{field: bad}).validate()
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--" + field.replace("_", "-"), bad])


@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_the_tpu_rng_paths_are_refused_with_a_reason(impl):
    JaxFedConfig(prng_impl=impl).validate()  # JAX's own choice
    with pytest.raises(ValueError, match="no counterpart on this card"):
        FedConfig(prng_impl=impl).validate()


@pytest.mark.parametrize("kw,match", [
    (dict(stack_dtype="bf16"), "bf16 chunks are not supported"),
    (dict(fused_epilogue="on"), "cannot apply to a streamed round"),
])
def test_the_cohort_refusals_are_jax_s(kw, match):
    base = dict(honest_size=8, byz_size=2, attack="signflip", agg="gm2", cohort_size=2)
    with pytest.raises(ValueError, match=match):
        FedConfig(**base, **kw).validate()
    with pytest.raises(ValueError, match=match):
        JaxFedConfig(**base, **kw, sharded=False).validate()
    # auto and f32 stream
    FedConfig(**base).validate()


def test_auto_resolves_to_the_plain_versions_on_the_cpu(ds):
    t = Trainer(FedConfig(honest_size=4, agg="median", noise_var=1e-2), dataset=ds,
                device="cpu")
    assert t._agg_impl == "xla" and not t._fused_epilogue and not t.channel_fused
    t = Trainer(FedConfig(honest_size=4, agg="median", noise_var=1e-2, fused_epilogue="on"),
                dataset=ds, device="cpu")
    assert t._agg_impl == "xla" and t.channel_fused


def test_pallas_is_refused_on_the_cpu(ds):
    with pytest.raises(ValueError, match="the CPU has none"):
        Trainer(FedConfig(honest_size=4, agg="gm2", agg_impl="pallas"), dataset=ds,
                device="cpu")
    argv = ["--agg-impl", "pallas", "--device", "cpu"]
    with pytest.raises(ValueError, match="the CPU has none"):
        tcli.config_from_args(tcli.build_parser().parse_args(argv)).validate()
    # the wrappers: a CPU tensor under "pallas" raises, never runs plain
    w = torch.ones(3, 5)
    with tkernels.implementation("pallas"):
        with pytest.raises(RuntimeError, match="a CPU tensor has none"):
            tkernels.fused_median(w)
        with pytest.raises(RuntimeError, match="a CPU tensor has none"):
            tagg.gm2(w)
    with tkernels.implementation("xla"):
        assert torch.equal(tkernels.fused_median(w), torch.ones(5))
    assert tkernels._IMPL is None
    with pytest.raises(ValueError, match="implementation must be"):
        with tkernels.implementation("cuda"):
            pass


def test_the_trainer_s_rules_run_under_its_impl(ds, monkeypatch):
    seen = []
    real = tagg.kernels.weiszfeld_step_fused

    def tap(*a, **kw):
        seen.append(tkernels._IMPL)
        return real(*a, **kw)

    monkeypatch.setattr(tkernels, "weiszfeld_step_fused", tap)
    t = Trainer(FedConfig(honest_size=4, agg="gm2", agg_maxiter=3, display_interval=1),
                dataset=ds, device="cpu")
    t.run_round(0)
    assert seen and set(seen) == {"xla"}
    assert tkernels._IMPL is None


def test_graphs_refuse_xla_and_admit_bf16():
    kw = dict(honest_size=8, byz_size=2, attack="classflip", agg="gm2", rounds=2,
              rounds_per_dispatch=2)
    graphed, why = tgraphs.dispatch_graph(FedConfig(**kw, agg_impl="xla"), "cuda")
    assert not graphed and "plain torch versions" in why
    assert tgraphs.dispatch_graph(FedConfig(**kw, stack_dtype="bf16"), "cuda")[0]
    assert tgraphs.dispatch_graph(FedConfig(**kw, agg_impl="pallas"), "cuda")[0]


# ---------------------------------------------------------------------------
# every rule on one bf16 stack


def _stack(k, d, seed, spread=1e-3):
    rng = np.random.default_rng(seed)
    base = 0.01 * rng.standard_normal((1, d))
    w = (base + spread * rng.standard_normal((k, d))).astype(np.float32)
    g = (w.mean(axis=0) + spread * rng.standard_normal(d)).astype(np.float32)
    return w, g


def _bf16(w):
    """The same bf16 stack for both sides (round to nearest even in both)."""
    w16 = w.astype(ml_dtypes.bfloat16)
    wt = torch.from_numpy(w16.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return jnp.asarray(w16), wt


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _jax_steps(run, maxiter):
    """The Weiszfeld steps JAX ran: the smallest maxiter whose output is the
    full run's bit for bit."""
    full = np.asarray(run(maxiter))
    lo, hi = 1, maxiter
    while lo < hi:
        mid = (lo + hi) // 2
        if np.array_equal(np.asarray(run(mid)), full):
            hi = mid
        else:
            lo = mid + 1
    return lo, full


def test_bf16_stacks_match_exactly():
    w, _ = _stack(5, 40, seed=0)
    wj, wt = _bf16(w)
    assert wt.dtype == torch.bfloat16 and wj.dtype == jnp.bfloat16
    assert np.array_equal(wt.to(torch.float32).numpy(), np.asarray(wj, np.float32))


def test_gm2_on_a_bf16_stack_matches_jax():
    k, d, tol, maxiter = 13, 300, 1e-6, 60
    w, g = _stack(k, d, seed=k)
    wj, wt = _bf16(w)
    n_jax, want = _jax_steps(
        lambda m: jagg.gm2(wj, guess=jnp.asarray(g), maxiter=m, tol=tol, impl="xla"),
        maxiter)
    got, n_port = tagg.gm2_solve(wt, guess=torch.from_numpy(g), maxiter=maxiter, tol=tol)
    assert 1 < n_jax < maxiter and n_port == n_jax
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("noise_var,tol,maxiter", [(None, 2e-3, 60), (1e-2, 2.5e-3, 120)])
def test_gm_on_a_bf16_stack_matches_jax_with_its_draws(noise_var, tol, maxiter):
    k, d = 13, 300
    w, g = _stack(k, d, seed=5)
    wj, wt = _bf16(w)
    key = jax.random.PRNGKey(42)
    n_jax, want = _jax_steps(
        lambda m: jagg.gm(wj, key=key, noise_var=noise_var, guess=jnp.asarray(g),
                          maxiter=m, tol=tol, impl="xla"),
        maxiter)
    h_r, h_i, z, sub_key = [], [], [], key
    for _ in range(maxiter):
        sub_key, sub = jax.random.split(sub_key)
        key_h, key_n = jax.random.split(sub)
        hr, hi = jchannel.rayleigh_fade(key_h, k)
        h_r.append(np.asarray(hr))
        h_i.append(np.asarray(hi))
        z.append(np.asarray(jax.random.normal(key_n, (d + 1,), dtype=jnp.float32)))
    got, n_port = tagg.gm_solve(
        wt, noise_var=noise_var, guess=torch.from_numpy(g), maxiter=maxiter, tol=tol,
        fades=(torch.from_numpy(np.stack(h_r)), torch.from_numpy(np.stack(h_i))),
        noise=torch.from_numpy(np.stack(z)))
    assert 1 < n_jax < maxiter and n_port == n_jax
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)


def test_mean_of_a_bf16_stack_accumulates_in_f32_like_jax():
    w, _ = _stack(12, 300, seed=2)
    wj, wt = _bf16(w)
    got = tagg.mean(wt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jagg.mean(wj)), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("k,d", [(13, 300), (10, 7850)])
def test_median_of_a_bf16_stack_is_jax_s_bitwise(k, d):
    w, _ = _stack(k, d, seed=k + d)
    w[-1] = np.nan
    wj, wt = _bf16(w)
    got = tagg.median(wt).numpy()
    assert np.array_equal(_bits(got), _bits(jagg.median(wj)))


@pytest.mark.parametrize("beta", [None, 2])
def test_trimmed_mean_of_a_bf16_stack_matches_jax(beta):
    w, _ = _stack(12, 200, seed=7)
    w[:4, ::2] = w[4, ::2]  # ties across the trim boundaries
    wj, wt = _bf16(w)
    got = tagg.trimmed_mean(wt, beta=beta).numpy()
    np.testing.assert_allclose(got, np.asarray(jagg.trimmed_mean(wj, beta=beta)),
                               rtol=1e-5, atol=1e-6)


def test_krum_on_a_bf16_stack_picks_jax_s_row():
    w, _ = _stack(12, 300, seed=11)
    w[8:] += 1.0
    wj, wt = _bf16(w)
    got = tagg.krum(wt, honest_size=8)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got.to(torch.float32).numpy()),
                          _bits(np.asarray(jagg.krum(wj, honest_size=8), np.float32)))


def test_bulyan_of_a_bf16_stack_matches_jax():
    w, _ = _stack(12, 300, seed=13)
    wj, wt = _bf16(w)
    got = tagg.bulyan(wt, honest_size=10).numpy()
    np.testing.assert_allclose(got, np.asarray(jagg.bulyan(wj, honest_size=10)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("clip_tau", [None, 1e-3])
def test_cclip_of_a_bf16_stack_matches_jax(clip_tau):
    w, g = _stack(12, 300, seed=5)
    wj, wt = _bf16(w)
    got = tagg.centered_clip(wt, guess=torch.from_numpy(g), clip_tau=clip_tau).numpy()
    want = np.asarray(jagg.centered_clip(wj, guess=jnp.asarray(g), clip_tau=clip_tau))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_signmv1_of_a_bf16_stack_is_jax_s_bitwise():
    from byzantine_aircomp_tpu_torch.interop import sign_words_to_jax

    k, d = 11, 7850
    w, g = _stack(k, d, seed=1)
    w[2] = g
    w[-1, 5] = np.nan
    wj, wt = _bf16(w)
    words, k_valid = tagg.pack_signs(wt, torch.from_numpy(g))
    want_words, want_valid = jagg.pack_signs(wj, jnp.asarray(g))
    assert np.array_equal(sign_words_to_jax(words), np.asarray(want_words))
    assert int(k_valid) == int(want_valid)
    key = jax.random.PRNGKey(17)
    want = np.asarray(jagg.sign_majority_vote(
        wj, guess=jnp.asarray(g), key=key, noise_var=1e-2, sign_eta=0.01, sign_bits=1))
    z = torch.from_numpy(np.array(jax.random.normal(key, (d,), dtype=jnp.float32)))
    got = tagg.sign_majority_vote(wt, guess=torch.from_numpy(g), noise_var=1e-2,
                                  sign_eta=0.01, sign_bits=1, vote_noise=z).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_the_trainer_hands_the_rule_a_bf16_stack(ds, monkeypatch):
    seen = []
    real = tagg.AGGREGATORS.get("gm2")

    def tap(w, **kw):
        seen.append(w.dtype)
        return real(w, **kw)

    cfg = FedConfig(honest_size=6, byz_size=2, attack="classflip", agg="gm2",
                    stack_dtype="bf16", display_interval=2, batch_size=8, agg_maxiter=20)
    t = Trainer(cfg, dataset=ds, device="cpu")
    monkeypatch.setattr(t, "agg_fn", tap)
    t.run_round(0)
    assert seen == [torch.bfloat16] * 2
    assert t.flat_params.dtype == torch.float32 and bool(torch.isfinite(t.flat_params).all())


# ---------------------------------------------------------------------------
# the channel fold, titles, hashes


def _run(ds, **kw):
    cfg = FedConfig(honest_size=8, byz_size=2, attack="classflip", agg="median",
                    noise_var=1e-2, rounds=2, display_interval=2, batch_size=8,
                    eval_train=False, **kw)
    t = Trainer(cfg, dataset=ds, device="cpu")
    for r in range(cfg.rounds):
        t.run_round(r)
    return t


def test_median_var_is_bitwise_alike_with_the_fold_on_off_and_auto(ds):
    runs = {mode: _run(ds, fused_epilogue=mode) for mode in ("on", "off", "auto")}
    assert runs["on"].channel_fused and not runs["off"].channel_fused
    assert not runs["auto"].channel_fused  # the CPU resolves to xla
    assert torch.equal(runs["on"].flat_params, runs["off"].flat_params)
    assert torch.equal(runs["auto"].flat_params, runs["off"].flat_params)


@pytest.mark.parametrize("kw", [
    dict(stack_dtype="bf16"),
    dict(prng_impl="rbg"),
    dict(agg_impl="xla"),
    dict(fused_epilogue="off"),
    dict(stack_dtype="bf16", agg="median", noise_var=1e-2, mark="m"),
])
def test_run_title_matches_jax(kw):
    kw = dict(dict(attack="classflip", honest_size=8, byz_size=2, agg="gm2"), **kw)
    assert tharness.run_title(FedConfig(**kw)) == jharness.run_title(JaxFedConfig(**kw))


def test_hash_keeps_defaults_and_forks_on_the_knobs():
    base = FedConfig(honest_size=8, byz_size=2, attack="classflip", agg="gm2")
    h = tharness.config_hash(base)
    explicit = dataclasses.replace(base, agg_impl="auto", fused_epilogue="auto",
                                   stack_dtype="f32", prng_impl="threefry")
    assert tharness.config_hash(explicit) == h
    for kw in (dict(agg_impl="xla"), dict(agg_impl="pallas"), dict(fused_epilogue="off"),
               dict(stack_dtype="bf16")):
        assert tharness.config_hash(dataclasses.replace(base, **kw)) != h


def test_the_run_start_event_records_the_resolved_impl(ds, tmp_path):
    import json

    cfg = FedConfig(honest_size=6, byz_size=2, attack="classflip", agg="gm2", rounds=1,
                    display_interval=1, batch_size=8, eval_train=False, agg_maxiter=5,
                    obs_dir=str(tmp_path), cache_dir=str(tmp_path), use_gpu=False)
    tharness.run_with_trainer(cfg, device="cpu", dataset=ds)
    (stream,) = tmp_path.glob("*.events.jsonl")
    start = next(e for e in map(json.loads, stream.read_text().splitlines())
                 if e["kind"] == "run_start")
    assert start["hbm"]["impl"] == "xla"


def test_smoke_diff_compares_launches_and_records_not_timings(tmp_path):
    """``tools/smoke_diff.py``: what two ``chip_smoke.py`` results must share
    (launch counts, records) is compared exactly, timings are not."""
    import json

    from byzantine_aircomp_tpu_torch.tools import smoke_diff

    parent = {"runs": {"b": {"launches": {"weiszfeld_step": 160}, "val_acc_path": [0.1, 0.5],
                             "rounds_per_sec": [20.0], "ms": 1.0}},
              "graphed_runs": {"z4": {"launches_per_round": {"w": 1e4}, "wall_seconds": 3}}}
    same = json.loads(json.dumps(parent))
    same["runs"]["b"]["rounds_per_sec"] = [9.0]
    same["knob_runs"] = {"ab": {}}
    moved = json.loads(json.dumps(parent))
    moved["runs"]["b"]["launches"]["weiszfeld_step"] = 161
    paths = {}
    for name, tree in (("parent", parent), ("same", same), ("moved", moved)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(tree))
    assert smoke_diff.main([str(paths["parent"]), str(paths["same"])]) == 0
    assert smoke_diff.main([str(paths["parent"]), str(paths["moved"])]) == 1
    n, diffs = smoke_diff.compare(parent, moved)
    assert n == 4 and diffs == [("/runs/b/launches/weiszfeld_step", 160, 161)]

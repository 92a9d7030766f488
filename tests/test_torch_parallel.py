"""The port's multi-GPU layouts on gloo process groups of 2 and 4 CPU ranks
(``torch.multiprocessing`` spawns), against the JAX package's
``parallel/`` on the conftest's 8-device CPU mesh and against the port's
own one-device paths.

One spawn per world size: every rank runs every check and writes its
results; the parametrized tests read them.  The ranks check:

* the collectives against JAX's ``parallel/collective.py`` at
  model_parallel 1 and 2: ``air_sum`` on JAX's own draws (1e-5), one
  ``sharded_weiszfeld_step`` with an Inf row (1e-5), ``ring_krum_scores``
  (relative 1e-5: the Gram form cancels);
* ``sharded_packed_vote_counts`` bitwise the one-device count and JAX's;
* ``MeshShardCtx`` bitwise ``SeqShardCtx`` on the streamed rules, and the
  population-sharded trainer bitwise the sequential engine;
* ``ShardedFedTrainer`` against the one-device ``Trainer`` for the nine
  rules of JAX ``tests/test_sharding.py:66-85`` x model_parallel {1, 2},
  K=16, two rounds, rtol 5e-4 and atol 5e-6 (JAX :112);
* that no rank all-gathers the client batch: the counterpart of JAX's
  ``test_hlo_client_step_shard_map_pin_prevents_batch_allgather``.  That
  JAX test fails before any assertion: its ``_round_hlo`` helper calls
  ``FedTrainer._round_core`` with an older signature (a TypeError, four
  arguments missing).  Its claim, that the pinned client step all-gathers
  nothing as large as the client batch, is the property held here (its
  counterfactual, GSPMD's own layout, has no counterpart in the port);
* a two-rank ``torch.distributed.checkpoint`` round trip.

Each rank runs on one thread.  The rest (the grid, the retries of
``multihost.initialize``, the harness's layout choice, the flags) runs in
this process.
"""

import functools
import json
import os
import socket
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from byzantine_aircomp_tpu_torch import cli as tcli
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.parallel import mesh as tmesh
from byzantine_aircomp_tpu_torch.parallel import multihost

RULES = [("mean", None), ("gm2", None), ("trimmed_mean", None), ("krum", None),
         ("gm", 1e-3), ("bulyan", None), ("cclip", None), ("signmv", 1e-3), ("dnc", None)]
# the carries by rows: client momentum on the split stack, the stale-replay
# buffer under a dropout fault on the gathered one
CARRIES = {"gm2 momentum": dict(agg="gm2", client_momentum=0.9),
           "mean dropout": dict(agg="mean", fault="dropout", dropout_prob=0.3)}
K_C, D_C = 16, 128  # the collectives' stack


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the spawned ranks (no JAX here: a child imports this module)


def _trainer_kw(agg, noise_var):
    kw = dict(honest_size=13, byz_size=3, attack="classflip", rounds=2, display_interval=1,
              batch_size=16, agg=agg, noise_var=noise_var, eval_train=False, agg_maxiter=50)
    return kw


def _check_collectives(spec, world):
    from byzantine_aircomp_tpu_torch.parallel import collective
    from byzantine_aircomp_tpu_torch.parallel.popmesh import sharded_packed_vote_counts
    from byzantine_aircomp_tpu_torch.ops import kernels

    out = {}
    for mp_ in (1, 2):
        grid = tmesh.make_mesh(model_parallel=mp_)
        rows = grid.row_block(K_C)
        cols = grid.col_block(D_C)
        t = {k: torch.from_numpy(v) for k, v in spec.items()}
        for nv, want in ((None, "air_clean"), (1e-2, "air_noisy")):
            got = collective.air_sum(grid, t["msg"][rows][:, cols], D_C, (t["h_r"], t["h_i"]),
                                     t["air_noise"], p_max=1.0, noise_var=nv, threshold=0.5)
            got = grid.gather_cols(got, D_C)
            out[f"air_sum nv={nv} mp={mp_}"] = float(torch.max(torch.abs(got - t[want])))
        w = t["wz"][rows][:, cols]
        got = grid.gather_cols(collective.sharded_weiszfeld_step(grid, w, t["guess"][cols]),
                               D_C)
        out[f"weiszfeld mp={mp_}"] = float(torch.max(torch.abs(got - t["weisz"])))
        scores = collective.ring_krum_scores(grid, t["wk"][rows][:, cols], 13, D_C)
        out[f"ring_krum mp={mp_}"] = float(torch.max(
            torch.abs(scores - t["krum"]) / torch.abs(t["krum"])))
    words = t["words"]
    rows = slice(dist.get_rank() * (K_C // world), (dist.get_rank() + 1) * (K_C // world))
    counts = sharded_packed_vote_counts(words[rows], 300)
    out["votes bitwise one device"] = bool(torch.equal(
        counts, kernels.packed_vote_counts(words, 300)))
    out["votes bitwise jax"] = bool(torch.equal(counts, t["votes"]))
    return out


def _check_pop_shards(world):
    from byzantine_aircomp_tpu_torch.data import datasets as tdata
    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.ops import aggregators as tagg
    from byzantine_aircomp_tpu_torch.ops import shardctx
    from byzantine_aircomp_tpu_torch.parallel import PopShardedFedTrainer
    from byzantine_aircomp_tpu_torch.parallel.popmesh import MeshShardCtx

    out = {}
    rng = np.random.default_rng(5)
    w = rng.normal(size=(8 * 2, 300)).astype(np.float32)
    w[3] = w[5]
    w[:, :10] = np.round(w[:, :10])
    w[[2, 9]] = np.nan
    tw = torch.from_numpy(w).reshape(8, 2, 300)
    kw = dict(k=16, d=300, n_chunks=8, device="cpu", degraded=True)
    for name, extra in (("median", {}), ("trimmed_mean", {}), ("mean", {}),
                        ("gm2", dict(maxiter=30)), ("median", dict(quantile="sketch"))):
        a = tagg.stream_aggregate(name, lambda c: tw[c], ctx=shardctx.SeqShardCtx(world),
                                  **kw, **extra)
        b = tagg.stream_aggregate(name, lambda c: tw[c], ctx=MeshShardCtx(world), **kw, **extra)
        out[f"mesh ctx {name} {extra}"] = bool(torch.equal(a, b))
    ds = tdata.load("mnist", synthetic_train=400, synthetic_val=100)
    cfg = dict(honest_size=6, byz_size=2, attack="signflip", agg="median", rounds=1,
               display_interval=2, batch_size=8, service="on", population=16,
               cohort_size=2, pop_shards=world, straggler_prob=0.1, noise_var=1e-3,
               defense="monitor", eval_train=False)
    seq = Trainer(FedConfig(**cfg), dataset=ds, device="cpu")
    mesh = PopShardedFedTrainer(FedConfig(**cfg), dataset=ds, device="cpu")
    v_seq, v_mesh = seq.run_round(0), mesh.run_round(0)
    out["pop trainer bitwise"] = bool(
        torch.equal(seq.flat_params, mesh.flat_params) and torch.equal(v_seq, v_mesh)
        and all(torch.equal(a, b) for a, b in zip(seq.defense_state[0], mesh.defense_state[0])))
    return out


def _check_trainers(world):
    from byzantine_aircomp_tpu_torch.data import datasets as tdata
    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.parallel import ShardedFedTrainer

    ds = tdata.load("mnist", synthetic_train=1600, synthetic_val=320)
    out = {}
    gathered = []
    real_gather = dist.all_gather

    def spy(tensors, tensor, *a, **k):
        gathered.append(tuple(tensor.shape))
        return real_gather(tensors, tensor, *a, **k)

    for mp_ in (1, 2):
        grid = tmesh.make_mesh(model_parallel=mp_)
        cases = [(agg, _trainer_kw(agg, nv)) for agg, nv in RULES] + [
            (name, dict(_trainer_kw(None, None), **kw)) for name, kw in CARRIES.items()]
        for agg, kw in cases:
            single = Trainer(FedConfig(**kw), dataset=ds, device="cpu")
            sharded = ShardedFedTrainer(FedConfig(**kw), dataset=ds, device="cpu", mesh=grid)
            del gathered[:]
            dist.all_gather = spy
            try:
                for r in range(2):
                    single.run_round(r)
                    sharded.run_round(r)
            finally:
                dist.all_gather = real_gather
            a, b = single.flat_params.numpy(), sharded.flat_params.numpy()
            err = np.max(np.abs(a - b) / (5e-6 + 5e-4 * np.abs(a)))
            # the client batch is [rows, B, 784] (and its labels [rows, B])
            batch = any(s[1:] in ((16, 784), (16,)) for s in gathered)
            split_rows = not sharded.gathers and not any(
                len(s) == 2 and s[1] == sharded.dim for s in gathered)
            out[f"trainer {agg} mp={mp_}"] = (float(err), bool(batch), split_rows,
                                              sharded.gathers)
            if agg in CARRIES:
                # the carries gathered whole equal the one-device trainer's
                mine, theirs = sharded.checkpoint_carries(), single.checkpoint_carries()
                got = mine[0] if mine[0] is not None else mine[1].stale
                want = theirs[0] if theirs[0] is not None else theirs[1].stale
                local = (sharded.client_m if sharded.client_m is not None
                         else sharded.fault_state.stale)
                out[f"carries {agg} mp={mp_}"] = (
                    float(torch.max(torch.abs(got - want))), tuple(local.shape))
    return out


def _check_checkpoint(tmp):
    from byzantine_aircomp_tpu_torch.utils import checkpoint as tckpt

    r = dist.get_rank()
    params = {"dense": {"kernel": torch.arange(12.0).reshape(3, 4) + 1.5,
                        "bias": torch.full((4,), 2.0)}}
    tckpt.save(tmp, "run_dist", 4, params)
    dist.barrier()
    back = tckpt.load(tmp, "run_dist", {"dense": {"kernel": torch.zeros(3, 4),
                                                   "bias": torch.zeros(4)}})
    files = sorted(os.listdir(os.path.join(tmp, "run_dist", "round_000004")))
    # a resumed sharded run (its carries by rows) against the straight one:
    # rank 0 writes the npz with the gathered carries, every rank reads it
    from byzantine_aircomp_tpu_torch.data import datasets as tdata
    from byzantine_aircomp_tpu_torch.fed import harness

    ds = tdata.load("mnist", synthetic_train=400, synthetic_val=100)
    kw = dict(honest_size=6, byz_size=2, attack="classflip", agg="gm2", batch_size=8,
              display_interval=1, eval_train=False, client_momentum=0.9, sharded=True,
              checkpoint_dir=os.path.join(tmp, "npz"), cache_dir=os.path.join(tmp, "rec"))
    straight, _ = harness.run_with_trainer(FedConfig(rounds=2, **dict(kw, checkpoint_dir="")),
                                           device="cpu", dataset=ds, record_in_file=False)
    harness.run_with_trainer(FedConfig(rounds=1, **kw), device="cpu", dataset=ds,
                             record_in_file=False)
    dist.barrier()
    resumed, _ = harness.run_with_trainer(FedConfig(rounds=2, inherit=True, **kw),
                                          device="cpu", dataset=ds, record_in_file=False)
    resume = bool(type(resumed).__name__ == "ShardedFedTrainer"
                  and torch.equal(resumed.flat_params, straight.flat_params)
                  and torch.equal(resumed.client_m, straight.client_m))
    return {"sharded resume bitwise": resume, "dcp round trip": bool(
        back[0] == 4 and torch.equal(back[1]["dense"]["kernel"], params["dense"]["kernel"])
        and torch.equal(back[1]["dense"]["bias"], params["dense"]["bias"])),
        "dcp rank file": f"__{r}_0.distcp" in files or r > 0}


def _read_spec(out_dir):
    """JAX's answers, which the parent writes while the ranks run their
    other parts."""
    path = os.path.join(out_dir, "spec.npz")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError("the parent wrote no JAX answers")
        time.sleep(0.05)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _worker(rank, world, port, out_dir, parts):
    torch.set_num_threads(1)
    results = {}
    try:
        multihost.initialize(coordinator=f"127.0.0.1:{port}", num_processes=world,
                             process_id=rank, device="cpu", timeout_s=120)
        for part in parts:
            t0 = time.perf_counter()
            try:
                if part == "collectives":
                    results.update(_check_collectives(_read_spec(out_dir), world))
                elif part == "pop":
                    results.update(_check_pop_shards(world))
                elif part == "trainers":
                    results.update(_check_trainers(world))
                elif part == "checkpoint":
                    results.update(_check_checkpoint(os.path.join(out_dir, "ckpt")))
            except Exception:  # noqa: BLE001 - reported to the parent
                results[f"error {part}"] = traceback.format_exc()
            results[f"seconds {part}"] = time.perf_counter() - t0
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        multihost.shutdown()


# ---------------------------------------------------------------------------
# the JAX side and the spawns


@functools.lru_cache(maxsize=None)
def _jax_spec():
    """The collectives' inputs and JAX's answers on its 8-device mesh."""
    import jax
    import jax.numpy as jnp

    from byzantine_aircomp_tpu.ops import aggregators as jagg
    from byzantine_aircomp_tpu.ops import channel as jchannel
    from byzantine_aircomp_tpu.parallel import collective as jcoll
    from byzantine_aircomp_tpu.parallel import mesh as jmesh

    rng = np.random.default_rng(0)
    spec = {}
    key = jax.random.PRNGKey(2)
    msg = rng.normal(size=(K_C, D_C)).astype(np.float32)
    key_h, key_n = jax.random.split(key)
    h_r, h_i = jchannel.rayleigh_fade(key_h, K_C)
    spec.update(msg=msg, h_r=np.asarray(h_r), h_i=np.asarray(h_i),
                air_noise=np.asarray(jax.random.normal(key_n, (D_C,), jnp.float32)))
    m2 = jmesh.make_mesh(model_parallel=2)
    spec["air_noisy"] = np.asarray(jcoll.air_sum(m2, key, jnp.asarray(msg), p_max=1.0,
                                                 noise_var=1e-2, threshold=0.5))
    # the noiseless receiver: JAX's sum less its noise term
    spec["air_clean"] = (spec["air_noisy"] - np.float32(np.sqrt(1e-2 / 2.0))
                         * spec["air_noise"]).astype(np.float32)
    wz = rng.normal(size=(K_C, D_C)).astype(np.float32)
    wz[5, 7] = np.inf
    guess = wz[np.isfinite(wz).all(axis=1)].mean(axis=0).astype(np.float32)
    spec.update(wz=wz, guess=guess, weisz=np.asarray(
        jcoll.sharded_weiszfeld_step(m2, jnp.asarray(wz), jnp.asarray(guess))))
    wk = (rng.normal(size=(K_C, D_C)) * np.linspace(0.5, 3.0, K_C)[:, None]).astype(np.float32)
    spec.update(wk=wk, krum=np.asarray(jcoll.ring_krum_scores(
        jmesh.make_mesh(model_parallel=2), jnp.asarray(wk), 13)))
    words = rng.integers(-(2**31), 2**31, size=(K_C, 10), dtype=np.int64).astype(np.int32)
    spec.update(words=words, votes=np.asarray(
        jagg._packed_vote_counts_xla(jnp.asarray(words.view(np.uint32)), 300)).astype(np.int32))
    return spec


SPAWN_TIMEOUT_S = 600


def _spawn(world, tmp, parts):
    """Run ``parts`` on ``world`` gloo ranks; the collectives' part comes
    last, and JAX's answers for it are computed here while the ranks run the
    others."""
    ctx = mp.start_processes(_worker, args=(world, _free_port(), str(tmp), parts),
                             nprocs=world, start_method="spawn", join=False)
    if "collectives" in parts:
        try:
            np.savez(os.path.join(tmp, "spec.tmp.npz"), **_jax_spec())
        except BaseException:
            for p in ctx.processes:
                p.kill()
            raise
        os.replace(os.path.join(tmp, "spec.tmp.npz"), os.path.join(tmp, "spec.npz"))
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    per_rank = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            per_rank.append(json.load(f))
    return per_rank


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("gloo2"),
                  ("pop", "trainers", "checkpoint", "collectives"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("gloo4"), ("pop", "collectives"))


@pytest.fixture(scope="module")
def four_trainers(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("gloo4t"), ("trainers",))


def _results(ranks, key):
    for r, res in enumerate(ranks):
        errors = {k: v for k, v in res.items() if k.startswith("error")}
        assert not errors, f"rank {r}: {errors}"
        assert key in res, f"rank {r} has no {key!r}: {sorted(res)}"
    return [res[key] for res in ranks]


_COLLECTIVE_KEYS = ([f"air_sum nv={nv} mp={m}" for nv in (None, 0.01) for m in (1, 2)]
                    + [f"weiszfeld mp={m}" for m in (1, 2)]
                    + [f"ring_krum mp={m}" for m in (1, 2)])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", _COLLECTIVE_KEYS)
def test_collectives_match_jax_on_its_mesh(request, world, key):
    ranks = request.getfixturevalue({2: "two", 4: "four"}[world])
    for err in _results(ranks, key):
        assert err < 1e-5, (key, err)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", ["votes bitwise one device", "votes bitwise jax"])
def test_sharded_vote_counts_are_bitwise(request, world, key):
    assert all(_results(request.getfixturevalue({2: "two", 4: "four"}[world]), key))


_POP_KEYS = ([f"mesh ctx {n} {{}}" for n in ("median", "trimmed_mean", "mean")]
             + ["mesh ctx gm2 {'maxiter': 30}", "mesh ctx median {'quantile': 'sketch'}",
                "pop trainer bitwise"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", _POP_KEYS)
def test_mesh_engine_is_bitwise_the_sequential_engine(request, world, key):
    assert all(_results(request.getfixturevalue({2: "two", 4: "four"}[world]), key))


@pytest.mark.parametrize("mp_", [1, 2])
@pytest.mark.parametrize("agg", [a for a, _ in RULES])
def test_sharded_trainer_matches_the_one_device_trainer(two, agg, mp_):
    for err, batch_gathered, split, gathers in _results(two, f"trainer {agg} mp={mp_}"):
        assert err <= 1.0, (agg, mp_, err)  # |a-b| <= 5e-6 + 5e-4 |a|
        assert not batch_gathered
        # mean, gm2, gm, krum and bulyan keep the stack split: no rank
        # gathers a [rows, d] block
        assert split == (agg in ("mean", "gm2", "gm", "krum", "bulyan")), gathers


@pytest.mark.slow
@pytest.mark.parametrize("mp_", [1, 2])
@pytest.mark.parametrize("agg", [a for a, _ in RULES] + list(CARRIES))
def test_sharded_trainer_matches_on_four_ranks(four_trainers, agg, mp_):
    """The same rules and carries on a (4, 1) and a (2, 2) grid: a second
    4-rank spawn of ~35 s on one CPU, so in the slow tier."""
    for err, batch_gathered, _split, _gathers in _results(four_trainers,
                                                          f"trainer {agg} mp={mp_}"):
        assert err <= 1.0 and not batch_gathered, (agg, mp_, err)


@pytest.mark.parametrize("mp_", [1, 2])
@pytest.mark.parametrize("name", list(CARRIES))
def test_carries_follow_the_stack_rows(two, name, mp_):
    """Client momentum (split stack) and the dropout fault's stale buffer
    (gathered stack) hold the rank's rows; gathered whole they are the
    one-device trainer's, within the trainer tolerance."""
    for err, batch_gathered, split, gathers in _results(two, f"trainer {name} mp={mp_}"):
        assert err <= 1.0 and not batch_gathered
        assert split == (name == "gm2 momentum"), gathers
    for err, local_shape in _results(two, f"carries {name} mp={mp_}"):
        assert err < 1e-4
        assert tuple(local_shape) == (16 // (2 // mp_), 7850)


def test_dcp_round_trip_on_two_ranks(two):
    assert all(_results(two, "dcp round trip"))
    assert all(_results(two, "dcp rank file"))


def test_a_sharded_run_resumes_bitwise(two):
    """Two ranks, gm2 with client momentum: one round checkpointed (rank 0
    writes the gathered carries) and resumed to two equals the straight two
    rounds, params and momentum rows, to the bit."""
    assert all(_results(two, "sharded resume bitwise"))


# ---------------------------------------------------------------------------
# in this process


def test_grid_blocks_and_factoring():
    assert tmesh.factor_devices(8) == (8, 1)
    assert tmesh.factor_devices(8, 2) == (4, 2)
    with pytest.raises(ValueError, match="must divide 8 devices"):
        tmesh.factor_devices(8, model_parallel=3)
    # word-aligned column blocks cover d exactly once
    spans = [tmesh._block(7850, 3, i, tmesh.COL_UNIT) for i in range(3)]
    assert spans[0][0] == 0 and spans[-1][1] == 7850
    assert all(a[1] == b[0] and a[1] % 32 == 0 for a, b in zip(spans, spans[1:]))
    grid = tmesh.make_mesh()  # no process group: one rank, identity collectives
    assert (grid.n_clients, grid.n_model, grid.size) == (1, 1, 1)
    t = torch.arange(4.0)
    assert grid.all_reduce(t.clone(), tmesh.CLIENT_AXIS).equal(t)
    assert grid.gather_rows(t).equal(t) and grid.row_block(16) == slice(0, 16)


def test_initialize_retries_with_backoff(monkeypatch):
    """JAX ``tests/test_multihost.py:162``: a flaky coordinator is retried with
    exponential backoff; on exhaustion the group stays down, and a later
    call retries cleanly and is idempotent once up."""
    monkeypatch.setattr(multihost, "_initialized", False)
    calls, sleeps = [], []
    monkeypatch.setattr(multihost.time, "sleep", lambda s: sleeps.append(s))

    def always_down(*a):
        calls.append(a)
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(multihost, "_connect", always_down)
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        multihost.initialize(coordinator="localhost:1", num_processes=2, process_id=1,
                             max_retries=2, backoff_s=0.5, timeout_s=7, device="cpu")
    assert len(calls) == 3 and sleeps == [0.5, 1.0]
    assert calls[0] == ("gloo", "localhost:1", 2, 1, 7)  # the connect timeout passed
    assert not multihost.is_initialized()

    calls.clear()

    def down_then_up(*a):
        calls.append(a)
        if len(calls) < 2:
            raise ConnectionError("refused")

    monkeypatch.setattr(multihost, "_connect", down_then_up)
    multihost.initialize(coordinator="localhost:1", num_processes=1, process_id=0,
                         backoff_s=0.0, device="cpu")
    assert len(calls) == 2 and multihost.is_initialized()
    multihost.initialize(coordinator="localhost:1")  # a no-op, not a reconnect
    assert len(calls) == 2
    monkeypatch.setattr(multihost, "_initialized", False)


def test_a_cuda_group_without_a_card_is_refused():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize(coordinator="localhost:1", num_processes=1, process_id=0)
    assert not multihost.is_initialized()


@pytest.fixture(scope="module")
def tiny():
    from byzantine_aircomp_tpu_torch.data import datasets as tdata

    return tdata.load("mnist", synthetic_train=200, synthetic_val=50)


@pytest.mark.parametrize("kw,world,want", [
    (dict(), 1, "Trainer"),
    (dict(sharded=True), 1, "ShardedFedTrainer"),
    (dict(agg="krum"), 2, "ShardedFedTrainer"),
    # auto keeps the Weiszfeld rules on one device; on forces the split
    (dict(), 2, "Trainer"),
    (dict(agg="gm", noise_var=1e-3), 2, "Trainer"),
    (dict(sharded=True), 2, "ShardedFedTrainer"),
    (dict(sharded=False), 2, "Trainer"),
    (dict(agg="krum", honest_size=7), 2, "Trainer"),  # K=9 does not divide over 2 ranks
    (dict(agg="mean", model_parallel=2), 2, "ShardedFedTrainer"),
    (dict(service="on", population=16, cohort_size=2, pop_shards=2, agg="median",
          attack="signflip"), 1, "Trainer"),
    (dict(service="on", population=16, cohort_size=2, pop_shards=2, agg="median",
          attack="signflip"), 2, "PopShardedFedTrainer"),
    (dict(service="on", population=16, cohort_size=2, pop_shards=2, agg="median",
          attack="signflip", sharded=False), 2, "Trainer"),
    # a group larger than pop_shards is refused (one shard per rank)
    (dict(service="on", population=16, cohort_size=2, pop_shards=2, agg="median",
          attack="signflip"), 4, ValueError),
    (dict(service="on", population=16, cohort_size=2, pop_shards=2, agg="median",
          attack="signflip", sharded=False), 4, "Trainer"),
])
def test_the_harness_picks_jax_s_layout(monkeypatch, tiny, kw, world, want):
    """JAX ``fed/harness.py:372-405`` on the process group's world size."""
    import byzantine_aircomp_tpu_torch.parallel as tpar

    made = []
    for name in ("ShardedFedTrainer", "PopShardedFedTrainer"):
        monkeypatch.setattr(tpar, name, (lambda n: lambda *a, **k: made.append(n))(name))
    monkeypatch.setattr(tharness, "Trainer", lambda *a, **k: made.append("Trainer"))
    monkeypatch.setattr(multihost, "process_count", lambda: world)
    monkeypatch.setattr(tmesh, "make_mesh", lambda model_parallel=None: tmesh.RankGrid.__new__(
        tmesh.RankGrid))
    monkeypatch.setattr(tmesh.RankGrid, "describe", lambda self: "{}")
    base = dict(honest_size=6, byz_size=2, attack="classflip", agg="gm2", rounds=1)
    base.update(kw)
    cfg = FedConfig(**base).validate()
    if want is ValueError:
        with pytest.raises(ValueError, match="pop_shards=2 runs one shard per rank.*4 ranks"):
            tharness.make_trainer(cfg, dataset=tiny, device="cpu")
        want = None
    else:
        tharness.make_trainer(cfg, dataset=tiny, device="cpu")
    assert made == ([want] if want else [])


def test_the_seven_flags_reach_their_fields():
    argv = ["--sharding", "off", "--model-parallel", "2", "--pop-shards", "4",
            "--device", "cpu"]
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(argv), argv)
    assert (cfg.sharded, cfg.model_parallel, cfg.pop_shards) == (False, 2, 4)
    for word, val in (("auto", None), ("on", True), ("off", False)):
        a = ["--sharding", word, "--device", "cpu"]
        assert tcli.config_from_args(tcli.build_parser().parse_args(a), a).sharded is val
    args = tcli.build_parser().parse_args(
        ["--multihost", "--coordinator", "h:1", "--num-processes", "3", "--process-id", "2"])
    assert (args.multihost, args.coordinator, args.num_processes, args.process_id) == (
        True, "h:1", 3, 2)
    # a preset keeps the explicit layout flags
    argv = ["--preset", "mnist_mlp_k50_b5_classflip", "--sharding", "on", "--device", "cpu"]
    assert tcli.config_from_args(tcli.build_parser().parse_args(argv), argv).sharded is True


def test_multihost_flags_bring_the_group_up_before_the_run(monkeypatch):
    seen = {}
    monkeypatch.setattr(multihost, "initialize", lambda **kw: seen.update(kw))
    monkeypatch.setattr(multihost, "process_summary", lambda: "summary")
    monkeypatch.setattr(tharness, "run", lambda cfg, device: seen.setdefault("run", device))
    tcli.main(["--coordinator", "h:5", "--num-processes", "2", "--process-id", "1",
               "--device", "cpu", "--K", "8", "--B", "2", "--attack", "classflip"])
    assert seen == dict(coordinator="h:5", num_processes=2, process_id=1, device="cpu",
                        run="cpu")

"""Checkpoint and resume of the port (``fed/checkpoint.py``,
``harness.run_with_trainer`` with ``checkpoint_dir``/``inherit``) on the
CPU, and its file format against the JAX package's.

R rounds straight through equal R1 rounds plus a resume to R bitwise: the
final params and every path but ``roundsPerSec`` (a host clock reading),
since every draw is keyed on (seed, round, iteration, stream) and the
fault state and the onset counter ride the checkpoint.  A port checkpoint
loads through the JAX package's ``checkpoint.load`` with the leaves the
JAX trainer of the same config carries, and the reverse.
"""

import os

import jax
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.fed import checkpoint as jcheckpoint
from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import checkpoint as tcheckpoint
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer


@pytest.fixture(scope="module")
def ds():
    return tdata.load("mnist_hard", synthetic_train=800, synthetic_val=200)


def _cfg(tmp_path, **kw):
    base = dict(honest_size=6, byz_size=2, attack="classflip", agg="gm2", rounds=3,
                display_interval=2, batch_size=8, dataset="mnist_hard", agg_maxiter=50,
                cache_dir=str(tmp_path / "records"))
    base.update(kw)
    return FedConfig(**base)


def _run(cfg, ds):
    return tharness.run_with_trainer(cfg, device="cpu", record_in_file=False, dataset=ds)


def _assert_same_run(a, b):
    (ta, ra), (tb, rb) = a, b
    assert torch.equal(ta.flat_params, tb.flat_params)
    assert set(ra) == set(rb)
    for key in ra:
        if key == "roundsPerSec":
            assert len(ra[key]) == len(rb[key])
        elif isinstance(ra[key], list):
            assert np.array_equal(np.asarray(ra[key]), np.asarray(rb[key]), equal_nan=True), key
        else:
            assert ra[key] == rb[key], key


@pytest.mark.parametrize("kw,r1", [
    (dict(), 1),
    (dict(agg="median", noise_var=1e-2, honest_size=8, fault="chaos", dropout_prob=0.3,
          corrupt_prob=0.5, corrupt_size=2), 2),
    (dict(attack="signflip@2"), 1),   # resumed before the onset
    (dict(attack="signflip@1"), 2),   # resumed after it
    (dict(attack="gradascent@1", agg="mean"), 1),  # resumed at it
], ids=["plain", "chaos", "signflip_before_onset", "signflip_after_onset",
        "gradascent_at_onset"])
def test_resume_equals_the_straight_run_bitwise(tmp_path, ds, kw, r1):
    straight = _run(_cfg(tmp_path, **kw), ds)
    ck = str(tmp_path / "ck")
    _run(_cfg(tmp_path, rounds=r1, checkpoint_dir=ck, **kw), ds)
    resumed = _run(_cfg(tmp_path, checkpoint_dir=ck, inherit=True, **kw), ds)
    _assert_same_run(straight, resumed)
    assert len(resumed[1]["valAccPath"]) == 4 and len(resumed[1]["variencePath"]) == 3
    if resumed[0].attack_iter is not None:
        assert int(resumed[0].attack_iter) == 6 == int(straight[0].attack_iter)
    if kw.get("fault"):
        assert sum(resumed[1]["faultDroppedPath"]) > 0


def test_chained_resumes_keep_the_whole_record(tmp_path, ds):
    """1 round, a resume to 2, another to 3: each checkpoint holds the whole
    run's paths, so the last record is the straight run's."""
    straight = _run(_cfg(tmp_path, attack="signflip@2"), ds)
    ck = str(tmp_path / "ck")
    for rounds, inherit in ((1, False), (2, True), (3, True)):
        resumed = _run(_cfg(tmp_path, attack="signflip@2", rounds=rounds, checkpoint_dir=ck,
                            inherit=inherit), ds)
    _assert_same_run(straight, resumed)
    assert len(resumed[1]["valAccPath"]) == 4


def test_resume_at_the_end_runs_no_round(tmp_path, ds, capsys):
    ck = str(tmp_path / "ck")
    first = _run(_cfg(tmp_path, rounds=2, checkpoint_dir=ck), ds)
    again = _run(_cfg(tmp_path, rounds=2, checkpoint_dir=ck, inherit=True), ds)
    _assert_same_run(first, again)
    assert "(no rounds run)" in capsys.readouterr().out


@pytest.mark.parametrize("damage", ["truncate", "garbage"])
def test_torn_checkpoint_restarts_from_round_0(tmp_path, ds, capsys, damage):
    ck = str(tmp_path / "ck")
    cfg = _cfg(tmp_path, rounds=1, checkpoint_dir=ck)
    _run(cfg, ds)
    path = tcheckpoint.checkpoint_file(ck, tharness.ckpt_title(cfg))
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2] if damage == "truncate" else b"\x00" * 64)
    capsys.readouterr()
    resumed = _run(_cfg(tmp_path, rounds=2, checkpoint_dir=ck, inherit=True), ds)
    out = capsys.readouterr().out
    assert out.count("Unreadable checkpoint") == 1 and "Resumed" not in out
    _assert_same_run(_run(_cfg(tmp_path, rounds=2), ds), resumed)


def test_leaf_count_mismatch_warns_and_keeps_the_state_fresh(tmp_path, ds):
    cfg = _cfg(tmp_path, attack="signflip@1", fault="dropout")
    t = Trainer(cfg, dataset=ds, device="cpu")
    assert [x.shape for x in tharness.extra_state(t)] == [(8, t.dim), ()]
    fresh = [x.clone() for x in tharness.extra_state(t)]
    flat = np.arange(t.dim, dtype=np.float32)
    lines = []
    start = tharness.restore_trainer(t, (2, flat, [np.int32(5)]), log_fn=lines.append)
    assert start == 2 and len(lines) == 1 and "WARNING" in lines[0] and "(1 leaves)" in lines[0]
    assert np.array_equal(t.flat_params.numpy(), flat)
    for a, b in zip(tharness.extra_state(t), fresh):
        assert torch.equal(a, b)
    # the JAX harness warns on the same mismatch
    jt = FedTrainer(JaxFedConfig(**_jax_kw(cfg)), dataset=ds)
    jlines = []
    jharness.restore_trainer(jt, JaxFedConfig(**_jax_kw(cfg)), (2, flat, [np.int32(5)]),
                             log_fn=jlines.append)
    assert len(jlines) == 1 and "(1 leaves)" in jlines[0]


def _jax_kw(cfg):
    return dict(honest_size=cfg.honest_size, byz_size=cfg.byz_size, attack=cfg.attack,
                agg=cfg.agg, fault=cfg.fault, dropout_prob=cfg.dropout_prob,
                display_interval=cfg.display_interval, batch_size=cfg.batch_size,
                dataset=cfg.dataset, seed=cfg.seed)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(attack="signflip@1"),
    dict(fault="chaos"),
    dict(fault="dropout", attack="alie@2"),
    dict(fault="csi"),
], ids=["no_extra", "onset", "chaos", "dropout_onset", "csi"])
def test_checkpoint_files_cross_load_with_jax(tmp_path, ds, kw):
    cfg = _cfg(tmp_path, **kw)
    jcfg = JaxFedConfig(**_jax_kw(cfg))
    jt = FedTrainer(jcfg, dataset=ds)
    j_leaves = jax.tree.leaves(jharness.extra_state(jt, jcfg))
    t = Trainer(cfg, dataset=ds, device="cpu")
    t_leaves = tharness.extra_state(t)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert tuple(a.shape) == np.shape(b) and a.numpy().dtype == np.asarray(b).dtype

    # port -> JAX: a moved state, read back leaf for leaf
    if t.attack_iter is not None:
        t.attack_iter = t.attack_iter + 7
    if t.fault_state is not None and t.fault_state.stale is not None:
        t.fault_state.stale.add_(0.25)
    t.flat_params = t.flat_params + 1.0
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tcheckpoint.save(port_dir, "run", 3, t.flat_params, tharness.extra_state(t), meta='{"a": 1}')
    with np.load(tcheckpoint.checkpoint_file(port_dir, "run")) as z:
        assert sorted(z.files) == sorted(
            ["round_idx", "flat_params", "meta_json"] + [f"opt_{i}" for i in range(len(t_leaves))])
    r, flat, leaves = jcheckpoint.load(port_dir, "run")
    assert r == 3 and np.array_equal(flat, t.flat_params.numpy())
    assert jcheckpoint.load_meta(port_dir, "run") == '{"a": 1}'
    for got, want in zip(leaves, tharness.extra_state(t)):
        assert got.dtype == want.numpy().dtype and np.array_equal(got, want.numpy())
    lines = []
    assert jharness.restore_trainer(jt, jcfg, (r, flat, leaves), log_fn=lines.append) == 3
    assert not lines
    for a, b in zip(jax.tree.leaves(jharness.extra_state(jt, jcfg)), tharness.extra_state(t)):
        assert np.array_equal(np.asarray(a), b.numpy())

    # JAX -> port, into a fresh trainer
    jcheckpoint.save(jax_dir, "run", 3, jt.flat_params,
                     jax.tree.leaves(jharness.extra_state(jt, jcfg)), meta="m")
    fresh = Trainer(cfg, dataset=ds, device="cpu")
    lines = []
    restored = tcheckpoint.load(jax_dir, "run")
    assert tharness.restore_trainer(fresh, restored, log_fn=lines.append) == 3 and not lines
    assert tcheckpoint.load_meta(jax_dir, "run") == "m"
    assert torch.equal(fresh.flat_params, t.flat_params)
    for a, b in zip(tharness.extra_state(fresh), tharness.extra_state(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_missing_checkpoint_loads_none(tmp_path):
    assert tcheckpoint.load(str(tmp_path), "nothing") is None
    assert tcheckpoint.load_meta(str(tmp_path), "nothing") is None


def test_ckpt_title_keys_on_every_result_affecting_field(tmp_path):
    cfg = _cfg(tmp_path)
    title = tharness.ckpt_title(cfg)
    assert title.startswith(tharness.run_title(cfg) + "_c") and len(title.split("_c")[-1]) == 8
    assert tharness.ckpt_title(_cfg(tmp_path, seed=2022)) != title
    assert tharness.ckpt_title(_cfg(tmp_path, honest_size=7)) != title
    assert tharness.ckpt_title(_cfg(tmp_path, gamma=0.02)) != title
    # the horizon, the paths and the resume switch do not split it
    same = _cfg(tmp_path, rounds=50, checkpoint_dir="x", inherit=True, cache_dir="y")
    assert tharness.ckpt_title(same) == title
    assert tharness.config_hash(_cfg(tmp_path, sign_bits=32)) == tharness.config_hash(cfg)


def test_inherit_without_checkpoint_dir_raises(tmp_path):
    with pytest.raises(ValueError, match="checkpoint-dir"):
        _cfg(tmp_path, inherit=True).validate()


def test_merge_paths_drops_the_duplicated_eval_like_jax():
    prefix = {"valAccPath": [0.1, 0.2], "variencePath": [1.0], "roundsPerSec": [3.0]}
    current = {"valAccPath": [0.2, 0.3], "variencePath": [2.0], "roundsPerSec": [4.0]}
    assert tharness.merge_paths(prefix, current) == jharness.merge_paths(prefix, current) == {
        "valAccPath": [0.1, 0.2, 0.3], "variencePath": [1.0, 2.0], "roundsPerSec": [3.0, 4.0]}


def test_atomic_write_leaves_the_old_file_on_failure(tmp_path):
    from byzantine_aircomp_tpu_torch.utils import io as io_lib

    path = str(tmp_path / "f.bin")
    io_lib.atomic_write(path, lambda f: f.write(b"old"))

    def boom(f):
        f.write(b"partial")
        raise RuntimeError("killed")

    with pytest.raises(RuntimeError):
        io_lib.atomic_write(path, boom)
    assert open(path, "rb").read() == b"old" and os.listdir(tmp_path) == ["f.bin"]

"""The port's presets (``presets.py``) and ``--preset`` against the JAX
package's: the cases of JAX's ``tests/test_presets.py`` on the port, and
every preset's port ``FedConfig`` equal to JAX's, field for field, on the
fields both have.  Each preset but the two K=1000 ResNet-18 ones runs one
round at a tiny size on the CPU; those two are built and validated, and
the port's memory model says in advance that their round does not fit one
80 GB card."""

import dataclasses

import pytest
import torch

from byzantine_aircomp_tpu import cli as jcli
from byzantine_aircomp_tpu import presets as jpresets
from byzantine_aircomp_tpu_torch import cli as tcli
from byzantine_aircomp_tpu_torch import presets
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for the tiny rounds' small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_names_cover_baseline_ladder():
    names = presets.names()
    assert "mnist_mlp_k50_baseline" in names
    assert "emnist_cnn_k200_b40_classflip" in names
    assert "cifar10_resnet18_k1000_b100_signflip_krum" in names
    assert names == jpresets.names() and len(names) == 12


def test_get_unknown_raises():
    with pytest.raises(KeyError, match="unknown preset"):
        presets.get("nope")


def test_overrides_win():
    cfg = presets.get("mnist_mlp_k50_b5_classflip", rounds=3, agg="median")
    assert cfg.rounds == 3 and cfg.agg == "median"
    assert cfg.attack == "classflip"  # preset value survives


@pytest.mark.parametrize("name", presets.names())
def test_each_preset_is_jax_s_field_for_field(name):
    port, want = presets.get(name), jpresets.get(name)
    assert presets.PRESETS[name] == jpresets.PRESETS[name]
    shared = ({f.name for f in dataclasses.fields(port)}
              & {f.name for f in dataclasses.fields(want)})
    assert len(shared) == 109
    for field in sorted(shared):
        assert getattr(port, field) == getattr(want, field), (name, field)
    assert port.validate() is port


RESNET_K1000 = [n for n in presets.names() if "resnet18_k1000" in n]


@pytest.mark.parametrize("name", [n for n in presets.names() if n not in RESNET_K1000])
def test_preset_runs_one_round_tiny(name):
    """Shrink topology/schedule, keep model/attack/agg/channel semantics."""
    has_attack = presets.PRESETS[name].get("attack") is not None
    bucketed = presets.PRESETS[name].get("bucket_size", 1) > 1
    cfg = presets.get(
        name,
        honest_size=5 if bucketed else 3,
        byz_size=1 if has_attack else 0,
        rounds=1,
        display_interval=1,
        batch_size=4,
        eval_batch=16,
        agg_maxiter=5,
        eval_train=False,
        fc_width=32,
    )
    ds = tdata.load(cfg.dataset, synthetic_train=64, synthetic_val=32)
    tr = Trainer(cfg, dataset=ds, device="cpu")
    tr.run_round(0)
    assert bool(torch.isfinite(tr.flat_params).all())
    loss, acc = tr.evaluate("val")
    assert loss == loss and 0.0 <= acc <= 1.0


@pytest.mark.parametrize("name", RESNET_K1000)
def test_the_k1000_resnet_presets_validate_but_do_not_fit_one_card(name):
    from byzantine_aircomp_tpu_torch.obs import hbm

    cfg = presets.get(name).validate()
    assert (cfg.model, cfg.node_size, cfg.dataset) == ("ResNet18", 1000, "cifar10")
    d = 11_173_962  # ResNet-18 at width 64 on CIFAR-10 (tests/test_torch_models.py)
    peak = hbm.cuda_peak_bytes(cfg.node_size, d, client_bytes=0)
    assert peak > 80e9  # three [1000, d] f32 stacks, before any activation


def _cfg(argv):
    return tcli.config_from_args(tcli.build_parser().parse_args(argv), argv)


def test_cli_preset_with_overrides():
    cfg = _cfg(["--preset", "mnist_mlp_k50_b10_classflip_air", "--rounds", "2"])
    assert cfg.rounds == 2  # explicit flag wins
    assert cfg.agg == "gm" and cfg.noise_var == 1e-2  # preset preserved
    assert cfg.byz_size == 10 and cfg.honest_size == 40


def test_cli_preset_K_B_override():
    cfg = _cfg(["--preset", "mnist_mlp_k50_baseline", "--K", "20", "--B", "4"])
    assert cfg.honest_size == 16 and cfg.byz_size == 4


def test_cli_preset_explicit_flag_at_default_value_wins():
    """A flag given explicitly overrides the preset even when its value
    equals the parser default (presence detection, not value comparison)."""
    cfg = _cfg(["--preset", "cifar10_resnet18_k1000_b100_signflip_krum", "--agg", "gm",
                "--dataset", "mnist"])
    assert cfg.agg == "gm"  # the parser default, but explicitly requested
    assert cfg.dataset == "mnist"
    assert cfg.model == "ResNet18"  # an untouched preset field survives


def test_cli_preset_eval_train_reenable():
    cfg = _cfg(["--preset", "emnist_cnn_k200_b40_classflip", "--eval-train"])
    assert cfg.eval_train is True
    assert _cfg(["--preset", "emnist_cnn_k200_b40_classflip"]).eval_train is False


def test_cli_preset_K_alone_keeps_total():
    """--K sets the total node count; the preset's Byzantine count is kept."""
    cfg = _cfg(["--preset", "cifar10_resnet18_k1000_b100_signflip_krum", "--K", "200"])
    assert cfg.node_size == 200 and cfg.byz_size == 100


def test_cli_unknown_preset_is_clean_error(capsys):
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--preset", "not_a_preset"])
    assert "invalid choice" in capsys.readouterr().err


def test_cli_preset_needs_its_argv():
    args = tcli.build_parser().parse_args(["--preset", "chaos"])
    with pytest.raises(ValueError, match="needs the argv"):
        tcli.config_from_args(args)


@pytest.mark.parametrize("argv", [
    ["--preset", "chaos", "--rounds", "3", "--stack-dtype", "bf16"],
    ["--preset", "mnist_hard_noniid_k20_b4_weightflip_median_bkt2", "--K", "10", "--B",
     "2", "--var", "0.01", "--fused-epilogue", "off"],
    ["--preset", "mnist_mlp_k50_baseline", "--agg-impl", "xla", "--seed", "2021",
     "--batch-size", "50"],
])
def test_cli_preset_merges_like_the_jax_cli(argv):
    port = _cfg(argv + ["--device", "cpu"])
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv), argv)
    for f in dataclasses.fields(FedConfig):
        if f.name != "use_gpu":
            assert getattr(port, f.name) == getattr(want, f.name), f.name
    assert port.use_gpu is False

"""One accuracy-gate run in the JAX package and in the port, in lockstep.

    PYTHONPATH=. JAX_PLATFORMS=cpu python benchmarks/paired_gate_trajectory.py \
        --gate cnn_gm2_classflip_b1 --seed 2029 --out paired_2029.json

Builds the JAX package's ``FedTrainer`` for one gate config of
``byzantine_aircomp_tpu_torch.tools.reproduce.GATES`` at one seed and the
port's ``Trainer`` on the CPU from the same initial params, then runs both
round by round on the same batch draws.  By default the draws are the JAX
run's: the JAX trainer runs its own jitted rounds, and the port takes the
uniforms the JAX round draws (``fold_in(key(seed), round)``, split over
the interval, then the iteration's first key:
``sample_client_batch_indices``' uniforms) and starts from the JAX
params.  With ``--draws FILE`` (``benchmarks/dump_gate_draws.py``) both
start from the port's initial params in the file and take its uniforms:
the JAX trainer runs its iterations one by one (jitted) with its batch
sampler fed from the file.  The gate configs draw nothing else (no channel, a
deterministic attack and aggregator), so the two runs differ only by
float rounding.  Writes both val accuracy paths, the params' largest
difference after each round, and the first round each run reaches 0.85
(its take-off) as JSON.

For the first ``--perturbed-rounds`` rounds a third run, the port from
the same params times (1 + 1e-7 N(0, 1)), takes the same iterations: how
fast its params leave the port's own shows how fast rounding differences
grow in this config by themselves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from byzantine_aircomp_tpu.data import datasets as jax_data
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.tools import reproduce

TAKE_OFF = 0.85


def _take_off(path):
    return next((r for r, a in enumerate(path) if a >= TAKE_OFF), None)


def _jax_draws(jt, r, k, b, interval):
    """The JAX round's batch uniforms, [interval, K, B]."""
    keys = jax.random.split(jax.random.fold_in(jt._base_key, r), interval)
    return np.stack([
        np.array(jax.random.uniform(jax.random.split(keys[i], 4)[0], (k, b),
                                    dtype=jnp.float32))
        for i in range(interval)])


def _feed_sampler(current):
    """Make the JAX package's batch sampler read ``current["u"]``."""

    def sample(key, offsets, sizes, batch_size):
        local = jnp.floor(current["u"] * sizes[:, None].astype(jnp.float32)).astype(jnp.int32)
        return offsets[:, None] + jnp.minimum(local, sizes[:, None] - 1)

    jax_data.sample_client_batch_indices = sample


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", default="cnn_gm2_classflip_b1",
                    choices=[g.name for g in reproduce.GATES])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--draws", default=None,
                    help="an npz of benchmarks/dump_gate_draws.py (default: the JAX run's)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--perturbed-rounds", type=int, default=4)
    args = ap.parse_args(argv)

    gate = next(g for g in reproduce.GATES if g.name == args.gate)
    data = dict(gate.data)
    ds = jax_data.load(data.pop("dataset"), **data)
    cfg = reproduce.gate_config(gate, args.seed)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name in JaxFedConfig.__dataclass_fields__}
    jt = FedTrainer(JaxFedConfig(**kw), dataset=ds)
    k, b, interval = cfg.node_size, cfg.batch_size, cfg.display_interval
    current = {}
    if args.draws is not None:
        z = np.load(args.draws)
        if int(z["seed"]) != args.seed:
            raise SystemExit(f"{args.draws} holds seed {int(z['seed'])}, not {args.seed}")
        file_u = z["u"]
        jt.flat_params = jnp.asarray(z["init_params"])
        _feed_sampler(current)
    tt = Trainer(cfg, dataset=ds, device="cpu",
                 params=torch.from_numpy(np.array(jt.flat_params)))
    noise = np.random.default_rng(args.seed).standard_normal(tt.dim).astype(np.float32)
    perturbed = tt.flat_params * (1 + 1e-7 * torch.from_numpy(noise))

    jax_acc, port_acc, diff = [jt.evaluate("val")[1]], [tt.evaluate("val")[1]], []
    perturbed_diff = []
    key = jax.random.PRNGKey(0)  # unused by the sampler fed from the file

    @jax.jit
    def file_step(carry, u):
        current["u"] = u  # traced: the jitted step is a function of u
        return jt._iteration(carry, key, jt.x_train, jt.y_train, False)[0]

    t0 = time.perf_counter()
    for r in range(cfg.rounds):
        if args.draws is None:
            us = _jax_draws(jt, r, k, b, interval)
            jt.run_round(r)
        else:
            us = file_u[r]
            carry = (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
                     jt.defense_state, jt.attack_iter, jt.service_state)
            for i in range(interval):
                carry = file_step(carry, jnp.asarray(us[i]))
            (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
             jt.defense_state, jt.attack_iter, jt.service_state) = carry
        params = tt.flat_params
        for i in range(interval):
            u = torch.from_numpy(np.ascontiguousarray(us[i]))
            params, _ = tt.iteration(params, draws={"u": u})
            if r < args.perturbed_rounds:
                perturbed, _ = tt.iteration(perturbed, draws={"u": u})
        tt.flat_params = params
        if r < args.perturbed_rounds:
            perturbed_diff.append(float((perturbed - params).abs().max()))
        jax_acc.append(jt.evaluate("val")[1])
        port_acc.append(tt.evaluate("val")[1])
        diff.append(float(np.abs(np.array(jt.flat_params) - params.numpy()).max()))
        print(f"round {r + 1}: val acc jax {jax_acc[-1]:.4f} port {port_acc[-1]:.4f} "
              f"params max abs diff {diff[-1]:.3e}", flush=True)
    res = {
        "gate": gate.name,
        "seed": args.seed,
        "draws": args.draws or "jax",
        "jax_valAccPath": jax_acc,
        "port_valAccPath": port_acc,
        "params_max_abs_diff": diff,
        "perturbed_port_params_max_abs_diff": perturbed_diff,
        "jax_tail_acc": reproduce.tail_accuracy({"valAccPath": jax_acc}),
        "port_tail_acc": reproduce.tail_accuracy({"valAccPath": port_acc}),
        "jax_take_off_round": _take_off(jax_acc),
        "port_take_off_round": _take_off(port_acc),
        "seconds": time.perf_counter() - t0,
    }
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(json.dumps({key: v for key, v in res.items() if not key.endswith(("Path", "diff"))}))


if __name__ == "__main__":
    main()

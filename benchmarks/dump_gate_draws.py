"""The port's initial params and batch draws of accuracy-gate runs.

    PYTHONPATH=. python benchmarks/dump_gate_draws.py --seeds 2024,2074 --out gate_draws

For each seed, builds the port's ``Trainer`` for one gate config of
``byzantine_aircomp_tpu_torch.tools.reproduce.GATES`` on ``--device``
(the card by default) and writes ``{out}/{gate}_{seed}.npz``: its initial
flat params and, for every round and iteration, the batch uniforms [K, B]
its run draws (``sample_client_batch_indices`` on the iteration's batch
generator; the gate configs draw nothing else).  Before writing, the first
iteration is run both ways, from the generators and from the dumped
uniforms, and must give the same params bit for bit.
``benchmarks/paired_gate_trajectory.py --draws`` replays a file in the
JAX package and in the port on the CPU.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from byzantine_aircomp_tpu_torch.data import datasets
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.tools import reproduce


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", default="cnn_gm2_classflip_b1",
                    choices=[g.name for g in reproduce.GATES])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    gate = next(g for g in reproduce.GATES if g.name == args.gate)
    data = dict(gate.data)
    ds = datasets.load(data.pop("dataset"), **data)
    os.makedirs(args.out, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        cfg = reproduce.gate_config(gate, seed)
        t = Trainer(cfg, dataset=ds, device=args.device)
        shape = (cfg.node_size, cfg.batch_size)
        u = np.stack([
            np.stack([
                torch.rand(shape, generator=t.iteration_generators(r, i).batch,
                           device=t.device, dtype=torch.float32).cpu().numpy()
                for i in range(cfg.display_interval)])
            for r in range(cfg.rounds)])
        from_gens, _ = t.iteration(t.flat_params, t.iteration_generators(0, 0))
        from_u, _ = t.iteration(t.flat_params, draws={"u": torch.from_numpy(u[0, 0]).to(t.device)})
        if not torch.equal(from_gens, from_u):
            raise SystemExit(f"seed {seed}: the dumped uniforms are not the run's draws")
        path = os.path.join(args.out, f"{gate.name}_{seed}.npz")
        np.savez(path, init_params=t.flat_params.cpu().numpy(), u=u, seed=seed,
                 device=str(t.device))
        print(f"{path}: u {u.shape}, d = {t.dim}")


if __name__ == "__main__":
    main()

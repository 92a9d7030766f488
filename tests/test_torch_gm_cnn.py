"""The noisy AirComp Weiszfeld solve (``gm`` with ``--var``) on the
full-width CNN, in the port and in the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg


def test_noisy_gm_diverges_on_the_full_cnn_in_both_packages():
    """The AirComp Weiszfeld solve at var 1e-2 blows up on the full-width
    CNN (d = 3,274,634) in the JAX package and in the port alike: the
    receiver noise on the guess has a norm ~ sqrt(d) sqrt(var/2) s / den,
    which outgrows the clients' spread, and every step then feeds it back
    through the scaler s.  (At the MLP's d = 7,850 it does not.)  So
    ``chip_smoke.py``'s run (r) holds the kernel against the plain version
    on the run's first stack instead of requiring finite params."""
    ds = tdata.load("mnist", synthetic_train=600, synthetic_val=50)
    cfg = FedConfig(model="CNN", agg="gm", noise_var=1e-2, honest_size=8, byz_size=2,
                    attack="classflip", batch_size=8, seed=3)
    t = Trainer(cfg, dataset=ds, device="cpu")
    u = torch.from_numpy(np.random.default_rng(0).random((10, 8), dtype=np.float32))
    idx = tdata.sample_client_batch_indices(t.offsets, t.sizes, 8, u=u)
    x = (t.x_train[idx].float() * t._norm_scale + t._norm_bias).reshape(10, 8, 28, 28)
    w = t.client_stack(t.flat_params, x, t.y_train[idx], t.byz_mask)
    g0 = t.flat_params
    spread = float(torch.linalg.vector_norm(w - g0, dim=1).max())

    port, _ = tagg.gm_solve(w, noise_var=1e-2, guess=g0, maxiter=20, tol=0.0,
                            generator=torch.Generator().manual_seed(1))
    ref = np.asarray(jagg.gm(jnp.asarray(w.numpy()), key=jax.random.PRNGKey(1),
                             guess=jnp.asarray(g0.numpy()), noise_var=1e-2, maxiter=20,
                             tol=0.0))
    for out in (port.numpy(), ref):
        moved = float(np.linalg.norm(out.astype(np.float64) - g0.numpy()))
        assert not np.isfinite(moved) or moved > 100 * spread, (moved, spread)

"""``python -m byzantine_aircomp_tpu_torch.sweep``: the (aggregator x
attack) matrix (:mod:`.analysis.sweep`)."""

from .analysis.sweep import main

if __name__ == "__main__":
    main()

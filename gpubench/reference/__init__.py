"""The plain reference of one federated iteration, in float32 PyTorch.

It imports nothing of the port or of the JAX package.  It follows the
published description (goldenBill/Byzantine_AirComp ``MNIST_Air_weight.py``):
each client takes one SGD step on its own batch from the round's weights,
the Byzantine clients train on flipped labels, the OMA channel corrupts the
stack, the rule aggregates it and the aggregate becomes the weights.  The
random draws are made again from the seed by :mod:`.draws`.
"""

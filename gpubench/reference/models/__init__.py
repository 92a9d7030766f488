"""The models' per-client gradients, one file a model: ``<model>.py`` gives
``client_grads(config, flat, x, y)``, the [K, d] f32 gradients of each
client's mean cross entropy over its own batch ``x`` [K, B, features], on
the flat vector that the configuration's ``layout`` lays out
(:mod:`..model`).  ``<model>`` is the configuration's ``model``."""

"""Name -> callable registries.

A copy of ``byzantine_aircomp_tpu/registry.py``: the port keeps its own so
that it imports nothing of the JAX package.  The reference dispatches CLI
strings to functions with ``eval`` (``MNIST_Air_weight.py:433`` and
``:580``); the same public names (``gm``, ``gm2``, ``mean``, ``classflip``,
``dataflip``, ``weightflip`` ...) resolve through explicit registries here.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional


class Registry:
    """A simple name -> object registry with decorator support.

    ``register`` accepts arbitrary static metadata keywords
    (``owns_channel``, ``extra_args``, ...) stored per entry and shared by
    aliases, read back through :meth:`meta`.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}
        self._meta: Dict[str, dict] = {}

    def register(
        self,
        name: Optional[str] = None,
        *,
        aliases: Iterable[str] = (),
        **meta,
    ):
        def wrap(fn: Callable) -> Callable:
            key = name or fn.__name__
            if key in self._entries:
                raise KeyError(f"duplicate {self.kind} registration: {key!r}")
            self._entries[key] = fn
            self._meta[key] = meta
            for alias in aliases:
                if alias in self._entries:
                    raise KeyError(f"duplicate {self.kind} alias: {alias!r}")
                self._entries[alias] = fn
                self._meta[alias] = meta
            return fn

        return wrap

    def get(self, name: str) -> Callable:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {known}"
            ) from None

    def meta(self, name: str) -> dict:
        """Static metadata attached at registration ({} when none given).
        Raises like :meth:`get` on unknown names so a typo can't read as
        an all-defaults entry."""
        self.get(name)
        return self._meta.get(name, {})

    def names(self):
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


AGGREGATORS = Registry("aggregator")
ATTACKS = Registry("attack")
MODELS = Registry("model")
DATASETS = Registry("dataset")
FAULTS = Registry("fault")

"""One round of the trainer as a CUDA graph, replayed once per round of a
multi-round dispatch.

The counterpart of the JAX package's single device program for R rounds
(``_build_multi_round_fn``, ``fed/train.py:1801``, a ``lax.scan`` over
``_round_core``): here the round is captured once per trainer and a dispatch
of R rounds is R replays with no host read between them.

* **Static buffers.**  The trainer's carried state (params, server
  optimizer, client momentum, fault, defense, onset counter and service
  state: ``Trainer._state()``) lives in buffers that the graph reads; the
  captured round ends by copying its new state into them.  A state that was
  replaced between dispatches (a resume, a rollback, a hook) is copied in
  before the next replay.
* **Random streams.**  ``run_round`` draws from one generator per
  (iteration slot, stream); each is registered with the graph, and before
  every replay each is seeded for the round it replays, so a replay draws
  what the eager round draws (``Trainer.reseed_slot_generators``).
* **Capture.**  After one eager warm-up round (from a copy of the state,
  thrown away), which loads the kernels, finds their launch plans, allocates
  the Weiszfeld workspaces and creates the generators, the round is
  captured on the warm-up's stream under
  ``torch.cuda.set_sync_debug_mode("error")``: a host read in the round
  raises, and so does any other failure of the capture.  Inside the capture
  the Weiszfeld loop runs all ``agg_maxiter`` steps with no host read
  (``ops.aggregators.weiszfeld_solve``).
* **Outputs.**  Each replay's per-round outputs (the variance, the fault,
  defense and service rows, and the forensic top-M, computed inside the
  graph into a static buffer) are copied into the dispatch's stacked
  buffers on the device.
* **Launch counts.**  The kernel wrappers count at capture, where nothing
  is launched: those counts are taken back out, and every replay adds them
  (``ops.kernels.add_launches``).

:func:`dispatch_graph` says which configurations are captured, and why not.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional, Tuple

import torch

from ..ops import kernels

def dispatch_graph(cfg, device) -> Tuple[bool, str]:
    """Whether a dispatch of ``cfg`` on ``device`` replays a CUDA graph of
    the round, and why (or why not), for the run's banner.  A rule or a
    model is captured where its registration says ``graphable=True`` (an
    alias shares its entry's metadata): each such one is held bitwise
    against its eager round on the card."""
    from .. import models  # noqa: F401  (registers the models)
    from ..ops import aggregators  # noqa: F401  (registers the rules)
    from ..ops import attacks as attack_lib
    from ..registry import AGGREGATORS, MODELS

    device = torch.device(device)
    if cfg.rounds_per_dispatch == 1:
        return False, "one round per dispatch: the per-round loop"
    if device.type != "cuda":
        return False, "CUDA graphs need the card: each round runs eagerly"
    if cfg.agg_impl == "xla":
        return False, ("--agg-impl xla runs the plain torch versions, the referee the "
                       "kernels are held against: its rounds run eagerly (a graph of them "
                       "is not held bitwise against its eager round on the card)")
    # the configurations with a host read inside their round
    if cfg.service == "on":
        return False, ("service rounds key the per-id link with a host int drawn every "
                       "iteration (link_key), which a capture would freeze")
    if cfg.cohort_size > 0:
        return False, ("a cohort-streamed round reads its rule's stopping test on the host "
                       "every pass")
    if cfg.defense == "adaptive":
        return False, "the adaptive defense reads its rung on the host every iteration"
    # the configurations not held against their eager round on the card
    if cfg.fault is not None:
        return False, ("fault rounds are not captured (the fault channel copies its "
                       "constants to the card, and the degraded rules are not held bitwise)")
    if cfg.participation < 1.0 or cfg.bucket_size > 1:
        return False, ("the participants' and the buckets' permutations (torch.randperm) "
                       "are not captured")
    rule = AGGREGATORS.meta(cfg.agg)
    if not rule.get("graphable", False):
        return False, (f"the rule {cfg.agg} is not captured: its round is not held bitwise "
                       "against its eager round")
    if not MODELS.meta(cfg.model).get("graphable", False):
        return False, (f"the model {cfg.model} is not captured: its round is not held "
                       "bitwise against its eager round")
    attack = attack_lib.resolve(cfg.attack)
    if attack is not None and attack.defense_aware:
        return False, "the defense-aware attacks are not captured"
    if rule.get("unrolled_solve", False):
        return True, (f"one CUDA graph of the round, replayed once per round; the graph "
                      f"runs all {cfg.agg_maxiter} Weiszfeld steps of every solve (a step "
                      "after convergence only copies the guess), so a solve that converges "
                      "early can run slower than eagerly")
    return True, "one CUDA graph of the round, replayed once per round"


def _copy_into(dst, src):
    """Copy the tensors of the state tree ``src`` into ``dst``'s, leaf for
    leaf (a leaf that already is its buffer is left alone)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class RoundGraph:
    """The CUDA graph of one round of ``trainer``: captured at the first
    :meth:`run`, replayed once per round after.  ``captures`` counts the
    captures (one per trainer), ``warmup_seconds`` and ``capture_seconds``
    time the warm-up round and the capture with its instantiation,
    ``replay_launches`` holds the kernel launches of one replay and
    ``replays`` counts them.  The graph is kept after instantiation
    (``keep_graph=True``), so that a measurement can count its nodes
    (``graph.raw_cuda_graph()``)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static = None
        self.outputs = None
        self.replay_launches: Dict[str, int] = {}
        self.captures = 0
        self.replays = 0
        self.warmup_seconds: Optional[float] = None
        self.capture_seconds: Optional[float] = None

    def capture(self, round_idx: int):
        """Warm up and capture the round (for the generators of round
        ``round_idx``); :meth:`run` calls it at its first dispatch."""
        from .train import _clone_state as _clone

        t = self.trainer
        dev = t.device
        self.static = _clone(t._state())
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            t._set_state(_clone(self.static))
            t.run_round(round_idx)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in t._slot_generators.values():
            graph.register_generator_state(g)
        t._set_state(self.static)
        before = dict(kernels.LAUNCHES)
        mode = torch.cuda.get_sync_debug_mode()
        # a trainer and its RoundGraph form a reference cycle, so an earlier
        # trainer's graph and pinned buffers are freed by the cyclic
        # collector, and a free that lands inside this capture invalidates
        # it: collect first, and keep the collector off until the capture
        # ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    variance = t.run_round(round_idx)
                    self.outputs = (variance, t.last_fault_metrics, t.last_defense_metrics,
                                    t.last_service_metrics, t.last_forensic_metrics)
                    _copy_into(self.static, t._state())
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.replay_launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        kernels.LAUNCHES.update(before)
        t._set_state(self.static)
        self.graph = graph
        self.captures += 1
        self.warmup_seconds = t1 - t0
        self.capture_seconds = time.perf_counter() - t1

    def run(self, start_round: int, num_rounds: int):
        """Replay rounds ``start_round ..`` ``num_rounds`` times (capturing
        first if need be); returns the stacked per-round outputs as
        ``Trainer.run_rounds_stacked`` does, with no host read."""
        from .train import DispatchOutputs

        t = self.trainer
        if self.graph is None:
            self.capture(start_round)
        _copy_into(self.static, t._state())
        t._set_state(self.static)
        stacked = [None if o is None else
                   torch.empty((num_rounds,) + tuple(o.shape), dtype=o.dtype, device=o.device)
                   for o in self.outputs]
        for i in range(num_rounds):
            t.reseed_slot_generators(start_round + i)
            self.graph.replay()
            kernels.add_launches(self.replay_launches)
            for buf, out in zip(stacked, self.outputs):
                if buf is not None:
                    buf[i].copy_(out)
        self.replays += num_rounds
        return DispatchOutputs(*stacked)

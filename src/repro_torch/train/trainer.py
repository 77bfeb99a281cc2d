"""Training loop with fault tolerance: checkpoint and auto-resume,
preemption handling, and a per-step watchdog.

Port of ``src/repro/train/trainer.py:40-221``:

* **Checkpoint/restart**: asynchronous atomic checkpoints every
  ``ckpt_every`` steps, at the last step and on preemption
  (``checkpoint.py``); on start the trainer resumes from the newest
  complete checkpoint. The data pipeline is seekable
  (``data/synthetic.py``), so a resume replays the same batches.
* **Preemption**: SIGTERM/SIGINT set a flag; the loop checkpoints at the
  next step boundary and exits cleanly.
* **Stragglers**: per-step wall times feed an EWMA watchdog; a step slower
  than ``straggler_factor`` × the EWMA is logged with its index.

The step (``make_train_step``) runs where the parameters are and never
moves them: the loss and its gradients by autograd, then
``optimizer.adamw_update`` in place under ``torch.no_grad()``. With
``cast_bf16`` the float32 matrices are cast to bfloat16 inside the graph,
so their gradients land on the float32 masters; microbatched accumulation
sums float32 gradients.

Sharded (``rules`` with a mesh; one process per rank, ``launch.train``):
the parameters are this rank's shards as ``param_specs`` (the reference's
argument, ``lm.param_specs``) lays them out, and the loss function takes
this rank's rows of the batch (``lm.train_loss(..., rules)``). The step
averages the gradients over the batch ranks, then ``adamw_update`` runs
on the shards with ZeRO-1 over the data ranks (``optimizer``). Under FSDP
(``rules.fsdp_axes``) the parameters are sharded over the data ranks too,
gathered where the model reads them (``make_train_step``). Under context
parallelism (``rules.context_parallel``: each model rank runs its block of
the sequence, ``lm``) the model ranks count as batch ranks when the
gradients are averaged (``average_over_batch_`` by the leaves' specs).
Checkpoints hold full leaves whatever the mesh (``checkpoint``), so a run
restarts on another mesh.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.dist.sharding import NO_SHARDING, FsdpShard, average_over_batch_, fsdp_cuts
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    opt_state_specs,
)
from repro_torch.utils.log import get_logger
from repro_torch.utils.tree import stacked_ndims, tree_leaves, tree_map, tree_unflatten

log = get_logger("repro_torch.trainer")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop."""

    def __init__(self):
        self.requested = False
        self._orig = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread (tests)
                pass
        return self

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; will checkpoint and exit", signum)
        self.requested = True

    def __exit__(self, *exc):
        for sig, orig in self._orig.items():
            signal.signal(sig, orig)


class Watchdog:
    """EWMA step-time tracker; flags straggler steps."""

    def __init__(self, factor: float):
        self.factor = factor
        self.ewma = None
        self.stragglers: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.factor * self.ewma
        if slow:
            self.stragglers.append((step, dt))
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)", step, dt, self.ewma)
        self.ewma = 0.9 * self.ewma + 0.1 * dt
        return slow


def loss_and_grads(loss_fn: Callable, params, batch, cast_bf16: bool = True, specs=None,
                   rules=NO_SHARDING):
    """``loss_fn(params, batch)`` and its gradient with respect to every
    leaf of ``params`` (a list in ``tree_leaves`` order; zeros for a leaf
    the loss does not use). With ``cast_bf16`` the float32 matrices enter
    the loss as bfloat16 copies made inside the graph, so the gradients
    are the float32 masters'. A matrix is a leaf of rank 2 or more in the
    reference's stacked tree (``utils.tree.stacked_ndims``): a group's
    norm scale is one, and is cast as the reference casts it. ``params``
    are not written.

    FSDP (``rules.fsdp_axes``, ``specs`` the FSDP specs): a leaf that its
    spec cuts over ``data`` enters the loss uncast, as a
    ``dist.sharding.FsdpShard`` that the model gathers where it runs
    (``gather_at_use``, which casts it by the same rule first), and its
    gradient comes back as this rank's slice of the sum over its data
    ranks (``make_train_step`` averages it)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    dtypes = [torch.bfloat16 if cast_bf16 and w.dtype == torch.float32 and r >= 2 else w.dtype
              for w, r in zip(leaves, stacked_ndims(params))]
    cuts = fsdp_cuts(specs, rules) if specs is not None else [None] * len(leaves)
    compute = [FsdpShard(w, *cut, dt) if cut is not None else w.to(dt)
               for w, dt, cut in zip(leaves, dtypes, cuts)]
    loss = loss_fn(tree_unflatten(params, compute), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(w) if g is None else g for w, g in zip(leaves, grads)]


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig, cast_bf16: bool = True,
                    accum_steps: int = 1, param_specs=None, rules=NO_SHARDING):
    """``loss_fn(params, batch) -> scalar``. Returns ``step_fn(params,
    opt_state, batch) -> (params, opt_state, metrics)``, which updates
    ``params`` and ``opt_state`` in place; metrics ``{"loss", "grad_norm",
    "lr"}`` are device scalars.

    ``accum_steps > 1``: the batch is split on its leading dim into that
    many microbatches, run one after another; their float32 gradients and
    losses are summed and divided by ``accum_steps``, so the optimizer sees
    the whole batch's mean with a microbatch's activations live.

    ``rules`` with a mesh: ``params`` are this rank's shards under
    ``param_specs``, ``opt_state`` is ``init_opt_state(params,
    param_specs, rules)``, and the gradients are averaged over the batch
    ranks before the update.

    FSDP (``rules.fsdp_axes``; ``param_specs`` the FSDP specs,
    ``dist.sharding.fsdp_specs``): the leaves cut over ``data`` are
    gathered where the model reads them and their gradients
    reduce-scattered (``loss_and_grads``); each is divided by its data
    ranks' count and averaged over the other batch dimensions only
    (``average_over_batch_``), and the optimizer updates the shard in
    place. With ``accum_steps > 1`` every microbatch gathers the leaves
    and reduce-scatters their gradients again: the reference hoists its
    gradient reduction out of the microbatch loop, which here would mean
    holding every leaf's full gradient between microbatches."""
    if rules.model_axis is not None and param_specs is None:
        raise ValueError("a tensor-parallel step needs the parameters' specs (param_specs)")

    def step_fn(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = loss_and_grads(loss_fn, params, batch, cast_bf16, param_specs, rules)
        else:
            micro = tree_map(lambda x: x.reshape(accum_steps, x.shape[0] // accum_steps,
                                                 *x.shape[1:]), batch)
            loss, grads = None, None
            for i in range(accum_steps):
                l, g = loss_and_grads(loss_fn, params, tree_map(lambda x: x[i], micro), cast_bf16,
                                      param_specs, rules)
                g = [t.float() for t in g]
                if grads is None:
                    loss, grads = l, g
                else:
                    loss = loss + l
                    torch._foreach_add_(grads, g)
            grads = torch._foreach_div(grads, float(accum_steps))
            loss = loss / accum_steps
        with torch.no_grad():
            average_over_batch_(grads, rules, param_specs)
            params, opt_state, metrics = adamw_update(
                opt_cfg, params, tree_unflatten(params, grads), opt_state, specs=param_specs,
                rules=rules)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step_fn


def state_specs(params, param_specs, rules=NO_SHARDING):
    """The specs of the trainer's state ``{"params", "opt"}``: the
    parameters' (under FSDP the FSDP specs the step runs on, so that a
    checkpoint gathers full leaves) and ``opt_state_specs``' (ZeRO-1 over
    the data ranks; an FSDP leaf's moments take its spec); None without a
    mesh."""
    if rules.mesh is None or param_specs is None:
        return None
    return {"params": param_specs, "opt": opt_state_specs(params, param_specs, rules.mesh)}


def train(params, loss_fn: Callable, batch_fn: Callable, cfg: TrainerConfig, *,
          opt_state=None, hooks: list[Callable] | None = None, param_specs=None,
          rules=NO_SHARDING):
    """Run the loop: ``batch_fn(step)`` gives each step's batch (a tree of
    tensors where the parameters are; this rank's rows under ``rules``).
    Returns (params, opt_state, history), history one ``{"step", "loss",
    "dt"}`` per step run. A resume restores the checkpoint onto the
    parameters' device (and this rank's shards of it)."""
    step_fn = make_train_step(loss_fn, cfg.opt, param_specs=param_specs, rules=rules)
    if opt_state is None:
        opt_state = init_opt_state(params, param_specs, rules)
    specs = state_specs(params, param_specs, rules)

    start = 0
    if cfg.ckpt_dir:
        latest = ckpt_lib.latest_step(cfg.ckpt_dir)
        if latest is not None:
            device = tree_leaves(params)[0].device
            state = ckpt_lib.restore(cfg.ckpt_dir, latest, {"params": params, "opt": opt_state},
                                     device=device, specs=specs, rules=rules)
            params, opt_state = state["params"], state["opt"]
            start = latest
            log.info("resumed from checkpoint step %d", start)

    watchdog = Watchdog(cfg.straggler_factor)
    history = []
    pending_ckpt = None
    with PreemptionGuard() as guard:
        for step in range(start, cfg.total_steps):
            t0 = time.time()
            batch = batch_fn(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            watchdog.observe(step, dt)
            history.append({"step": step, "loss": loss, "dt": dt})
            if step % cfg.log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            for h in hooks or []:
                h(step, params, metrics)
            must_ckpt = cfg.ckpt_dir and ((step + 1) % cfg.ckpt_every == 0
                                          or step + 1 == cfg.total_steps or guard.requested)
            if must_ckpt:
                if pending_ckpt is not None:
                    pending_ckpt.join()
                pending_ckpt = ckpt_lib.save(cfg.ckpt_dir, step + 1,
                                             {"params": params, "opt": opt_state},
                                             keep=cfg.ckpt_keep, specs=specs, rules=rules)
            if guard.requested:
                log.warning("exiting at step %d after preemption checkpoint", step + 1)
                break
    if pending_ckpt is not None:
        pending_ckpt.join()
    return params, opt_state, history

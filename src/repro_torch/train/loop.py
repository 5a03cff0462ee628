"""Fault-tolerant training loop.

Port of ``src/repro/train/loop.py``:
  * checkpoint/restart — atomic manager, deterministic data resume
    (step -> batch is a pure function, so a restarted run replays the
    exact stream; bitwise on the CPU in tests/test_torch_train.py);
  * preemption handling — SIGTERM sets a flag, the loop checkpoints and
    exits cleanly at the next step boundary;
  * straggler watchdog — per-step wall time tracked; steps slower than
    ``watchdog_factor``× the running median are logged as stragglers;
  * elastic restart — the data shard mapping is recomputed from the
    new world size at restore (nothing in the checkpoint binds it);
  * optional int8 error-feedback gradient compression
    (``distributed/compression.py``).

The step runs eagerly (the reference jits it): autograd per microbatch,
then compression, clipping and the optimizer's in-place update.  The
per-step ``float(loss)`` is host-synchronous, as in the reference.
Entry points run on the card unless given a CPU device.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..data.tokens import DataConfig, shard_batch
from ..distributed.compression import ef_compress, ef_init
from ..distributed.sharding import Planner
from ..models.params import _device, tree_leaves, tree_map
from ..optim import clip_by_global_norm, make_optimizer
from ..optim.schedules import cosine_with_warmup


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 20
    clip_norm: float = 1.0
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    log_every: int = 10
    watchdog_factor: float = 3.0
    grad_compression: bool = False


def _with_leaves(tree, leaves: list):
    """``tree``'s structure (nested dicts, tuples, lists) holding
    ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _loss_and_grads(model, planner, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = model.loss(_with_leaves(params, leaves), batch, planner)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def compute_grads(model, planner: Planner, params, batch,
                  microbatch: int = 1):
    """``(loss, grads)`` with optional gradient-accumulation
    microbatching: the batch is split on its leading axis and each
    microbatch differentiated in turn (``torch.autograd.grad``, so no
    bf16 ``.grad`` accumulates), so activation memory scales with
    B/microbatch while the math is the reference's: each microbatch's
    grads cast to ``cfg.grad_acc_dtype``, divided by ``microbatch`` and
    added, in microbatch order; the loss accumulated as
    ``loss / microbatch``.  With one microbatch the grads keep the
    parameters' dtype, as the reference's ``value_and_grad``."""
    if microbatch <= 1:
        loss, grads = _loss_and_grads(model, planner, params, batch)
        return loss, _with_leaves(params, grads)

    def slice_mb(x, i):
        b = x.shape[0]
        assert b % microbatch == 0, (b, microbatch)
        n = b // microbatch
        return x[i * n:(i + 1) * n]

    acc_dtype = getattr(torch, getattr(model.cfg, "grad_acc_dtype",
                                       "float32"))
    params_l = tree_leaves(params)
    acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
           for p in params_l]
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=params_l[0].device)
    for i in range(microbatch):
        mb = tree_map(lambda x: slice_mb(x, i), batch)
        loss, grads = _loss_and_grads(model, planner, params, mb)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                a.add_(g.to(acc_dtype) / microbatch)
        del grads
        loss_acc = loss_acc + loss / microbatch
    return loss_acc, _with_leaves(params, acc)


def make_train_step(model, planner: Planner, opt_update,
                    clip_norm: float = 1.0, grad_compression: bool = False):
    """The train step: loss -> grads -> (compress) -> clip -> update.
    ``step_fn(params, opt_state, batch, ef_state)`` returns ``(params,
    opt_state, ef_state, {"loss", "grad_norm"})``; the parameters and
    the optimizer's moments are updated in place, the gradients clipped
    in place."""
    microbatch = model.cfg.microbatch

    def step_fn(params, opt_state, batch, ef_state):
        loss, grads = compute_grads(model, planner, params, batch,
                                    microbatch)
        if grad_compression:
            grads, ef_state = ef_compress(grads, ef_state)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, inplace=True)
        params, opt_state = opt_update(grads, opt_state, params)
        return params, opt_state, ef_state, {"loss": loss, "grad_norm": gnorm}

    return step_fn


class Trainer:
    def __init__(self, model, data_cfg: DataConfig, train_cfg: TrainConfig,
                 planner: Optional[Planner] = None, shard: int = 0,
                 n_shards: int = 1, device=None):
        self.model = model
        self.data_cfg = data_cfg
        self.cfg = train_cfg
        self.planner = planner or Planner.null()
        self.shard, self.n_shards = shard, n_shards
        self.device = _device(device)

        lr = cosine_with_warmup(train_cfg.lr, train_cfg.warmup,
                                train_cfg.steps)
        opt_init, opt_update, _ = make_optimizer(model.cfg.optimizer, lr)
        self.opt_init = opt_init
        self.step_fn = make_train_step(
            model, self.planner, opt_update, train_cfg.clip_norm,
            train_cfg.grad_compression)
        self.ckpt = CheckpointManager(train_cfg.checkpoint_dir)
        self._preempted = False
        self.metrics: list = []

    def request_preemption(self, *_args):
        self._preempted = True

    def install_signal_handler(self):
        signal.signal(signal.SIGTERM, self.request_preemption)

    def run(self, init_params=None, resume: bool = True,
            fail_at_step: Optional[int] = None) -> Dict[str, Any]:
        """Run to cfg.steps.  ``init_params`` is copied (the step updates
        its own tensors in place); without it the weights are drawn from
        ``torch.Generator(device).manual_seed(0)``.  fail_at_step
        simulates a hard node failure (raises) for the fault-tolerance
        tests."""
        if init_params is not None:
            params = tree_map(lambda p: p.detach().to(self.device,
                                                      copy=True),
                              init_params)
        else:
            params = self.model.init(
                torch.Generator(device=self.device).manual_seed(0),
                device=self.device)
        opt_state = self.opt_init(params)
        ef_state = ef_init(params) if self.cfg.grad_compression else \
            tree_map(lambda p: torch.zeros((1,), dtype=torch.float32,
                                           device=p.device), params)
        start = 0

        if resume:
            got = self.ckpt.restore_latest((params, opt_state))
            if got[0] is not None:
                start, (params, opt_state), extra = got
                start += 1  # checkpoint stores a completed step

        times: list = []
        for step in range(start, self.cfg.steps):
            if self._preempted:
                self.ckpt.save(step - 1, (params, opt_state),
                               {"reason": "preempt"}, block=True)
                return {"params": params, "opt_state": opt_state,
                        "stopped_at": step, "preempted": True,
                        "metrics": self.metrics}
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"simulated node failure at step {step}")

            t0 = time.perf_counter()
            batch_np = shard_batch(self.data_cfg, step, self.shard,
                                   self.n_shards)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch_np.items()}
            params, opt_state, ef_state, m = self.step_fn(
                params, opt_state, batch, ef_state)
            rec = {"step": step, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"])}
            dt = time.perf_counter() - t0
            times.append(dt)
            med = float(np.median(times[-21:]))
            straggler = len(times) > 5 and dt > self.cfg.watchdog_factor * med
            rec.update(time_s=dt, straggler=bool(straggler))
            self.metrics.append(rec)
            if step % self.cfg.log_every == 0:
                print(f"step {step:5d} loss {rec['loss']:.4f} "
                      f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f} ms"
                      + ("  [STRAGGLER]" if straggler else ""))
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, (params, opt_state),
                               {"loss": rec["loss"]})

        self.ckpt.save(self.cfg.steps - 1, (params, opt_state), {},
                       block=True)
        return {"params": params, "opt_state": opt_state,
                "stopped_at": self.cfg.steps, "preempted": False,
                "metrics": self.metrics}

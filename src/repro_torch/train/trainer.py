"""The Trainer: the data stream, the training step, checkpointing,
straggler monitoring and preemption in one supervised loop, the
reference's ``repro/train/trainer.py`` on one device.

The step runs eagerly (autograd is not captured into a CUDA graph). A
state is drawn from ``run.seed`` on ``device``, or restored from the
latest checkpoint in ``run.checkpoint_dir``, whose cursor says where the
loop resumes; a caller may also set ``state`` before ``train()`` (a
converted reference state, say). Training over a device mesh is not
ported: ``mesh=`` raises.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_stream
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import PreemptionHandler, StragglerMonitor
from repro_torch.train.step import TrainState, init_train_state, \
    make_train_step


@dataclass
class Trainer:
    run: RunConfig
    _: dataclasses.KW_ONLY
    device: Any = "cuda"
    mesh: Optional[Any] = None
    engine: Any = None                      # core.offload.OffloadEngine
    install_signal_handler: bool = False
    fault_hook: Optional[Callable[[int], None]] = None  # tests: raise at N
    vocab_cap: Optional[int] = None         # smoke: cap the synthetic vocab

    state: Optional[TrainState] = None
    history: List[Dict[str, float]] = field(default_factory=list)
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "training over a device mesh is not ported yet (ROADMAP "
                "Queue A: Trainer(mesh=) and --mesh)")
        self.device = resolve_device(self.device)
        self.stream = make_stream(self.run.model, self.run.shape,
                                  seed=self.run.seed,
                                  vocab_cap=self.vocab_cap,
                                  device=self.device)
        self._step_fn = None
        self._preempt = PreemptionHandler(install=self.install_signal_handler)
        self._start_step = 0

    # ------------------------------------------------------------------
    def _init_or_restore(self):
        gen = torch.Generator(device=self.device).manual_seed(self.run.seed)
        self.state = init_train_state(gen, self.run.model, self.run.optimizer,
                                      max_positions=self.run.shape.seq_len,
                                      device=self.device)
        ckpt = ckpt_lib.latest_checkpoint(self.run.checkpoint_dir)
        self._start_step = 0
        if ckpt is not None:
            self.state, manifest = ckpt_lib.load_checkpoint(ckpt, self.state)
            self._start_step = manifest["cursor"]["step"]

    # ------------------------------------------------------------------
    def train(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Run (or resume) the loop. Returns the last step's metrics."""
        if self.state is None:
            self._init_or_restore()
        if self._step_fn is None:
            self._step_fn = make_train_step(self.run.model,
                                            self.run.optimizer,
                                            engine=self.engine)
        steps = steps if steps is not None else self.run.steps
        metrics: Dict[str, float] = {}
        for s in range(self._start_step, steps):
            if self.fault_hook is not None:
                self.fault_hook(s)
            t0 = time.perf_counter()
            batch = self.stream.batch_at(s)
            self.state, m = self._step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in m.items()}  # syncs the card
            dt = time.perf_counter() - t0
            straggler = self.monitor.observe(s, dt)
            metrics.update(step=s, dt_s=dt, straggler=float(straggler))
            self.history.append(metrics)

            final_step = s == steps - 1
            want_ckpt = (self.run.checkpoint_every
                         and (s + 1) % self.run.checkpoint_every == 0)
            if want_ckpt or self._preempt.requested or final_step:
                self.save(step=s + 1)
            if self._preempt.requested:
                break
        self._start_step = len(self.history) and (self.history[-1]["step"] + 1)
        return metrics

    def save(self, step: int) -> str:
        path = ckpt_lib.save_checkpoint(
            self.run.checkpoint_dir, self.state, step=step, cursor_step=step,
            seed=self.run.seed,
            metadata={"model": self.run.model.name,
                      "shape": self.run.shape.name})
        ckpt_lib.remove_old_checkpoints(self.run.checkpoint_dir, keep=3)
        return path

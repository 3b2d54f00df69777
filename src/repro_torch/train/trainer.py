"""The Trainer: the data stream, the training step, checkpointing,
straggler monitoring and preemption in one supervised loop, the
reference's ``repro/train/trainer.py``, on one device or over a mesh.

The step runs eagerly (autograd is not captured into a CUDA graph). A
state is drawn from ``run.seed`` on ``device``, or restored from the
latest checkpoint in ``run.checkpoint_dir``, whose cursor says where the
loop resumes; a caller may also set ``state`` before ``train()`` (a
converted reference state, say).

With ``mesh=`` (a ``launch.mesh.Mesh`` of logical devices; ``cpu``
entries need no card) the state is drawn on the first data shard's
device and stored split by ``train_state_specs`` (``self.specs``), a
checkpoint restores onto the mesh's owners, and each step is the mesh
step of ``train/step.py``, its attention and dense FFN blocks split over
"model" where their heads and d_ff divide (``tp_summary()`` counts them);
``device`` is then ignored. Checkpoints hold
whole leaves either way. ``whole_state()`` gathers the state onto one
device.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import tree
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_stream
from repro_torch.launch.mesh import physical_device
from repro_torch.sharding import rules
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import PreemptionHandler, StragglerMonitor
from repro_torch.train.step import TrainState, init_train_state, \
    make_train_step, split_train_state


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

    specs: Optional[TrainState] = None      # the split state's specs

    def __post_init__(self):
        if self.mesh is not None:
            if self.mesh.is_abstract:
                raise ValueError("an abstract mesh has no devices to "
                                 "train on")
            for dev in self.mesh.physical_devices:
                resolve_device(dev)
            self.device = physical_device(self.mesh.batch_devices()[0])
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
        if self.mesh is not None:
            self.specs = rules.train_state_specs(self.state, self.mesh)
            if ckpt is None:
                self.state = rules.split_tree(self.state, self.specs,
                                              self.mesh)
            else:                   # the drawn leaves give their shapes
                template = tree.map_with_path(
                    lambda _, t: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), self.state)
                self.state = None
                self.state, manifest = ckpt_lib.load_checkpoint(
                    ckpt, template, mesh=self.mesh, specs=self.specs)
                self._start_step = manifest["cursor"]["step"]
        elif ckpt is not None:
            self.state, manifest = ckpt_lib.load_checkpoint(ckpt, self.state)
            self._start_step = manifest["cursor"]["step"]

    def tp_summary(self) -> Dict[str, int]:
        """Over a mesh, how many layers run each mixer and FFN split over
        "model" and how many whole, by reason (``rules.tp_summary``);
        {} without a mesh."""
        if self.mesh is None:
            return {}
        if self.state is None:
            self._init_or_restore()
        specs = self.specs or rules.train_state_specs(self.state, self.mesh)
        return rules.tp_summary(self.run.model, specs.params, self.mesh)

    def whole_state(self, device=None) -> TrainState:
        """The state with every leaf whole on ``device`` (default: the
        trainer's): a split state gathered, an unsplit one as it is."""
        if self.mesh is None or not rules.is_split(self.state):
            return self.state
        return rules.gather_tree(self.state, self.specs, self.mesh,
                                 device or self.device)

    # ------------------------------------------------------------------
    def train(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Run (or resume) the loop. Returns the last step's metrics."""
        if self.state is None:
            self._init_or_restore()
        if self.mesh is not None and not rules.is_split(self.state):
            self.state, self.specs = split_train_state(self.state, self.mesh)
        if self._step_fn is None:
            self._step_fn = make_train_step(self.run.model,
                                            self.run.optimizer,
                                            engine=self.engine,
                                            mesh=self.mesh, specs=self.specs)
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
                      "shape": self.run.shape.name},
            mesh=self.mesh, specs=self.specs)
        ckpt_lib.remove_old_checkpoints(self.run.checkpoint_dir, keep=3)
        return path

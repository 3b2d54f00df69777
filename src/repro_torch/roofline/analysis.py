"""Roofline analysis of a counted program (no card needed), the port's
counterpart of the reference's ``roofline/analysis.py``.

Three terms per (arch x shape x mesh) cell, in seconds, for one logical
entry of the mesh (the busiest, unless asked for another):

  compute    = FLOPs of the entry      / peak FLOP/s of one card
  memory     = bytes the entry moves   / device-memory bytes/s
  collective = collective bytes        / link bytes/s (one direction)

The quantities come from ``roofline/op_cost.py``'s counter, which runs the
port's eager program over fake (or real CPU) tensors and attributes every
operation to the entry that runs it, so each quantity is already per
device and the chips factors of the terms cancel, as in the reference.

Two collective accountings are kept (``CollectiveStats``):
  raw   the result bytes of each collective (the reference's convention)
  wire  ring-model bytes crossing links per device: all-reduce
        2(n-1)/n x bytes, all-gather and all-to-all (n-1)/n x bytes,
        reduce-scatter (n-1) x the scattered shard, permute 1x.

The hardware is a ``HW`` of one card: ``H100`` by default, whose figures
are NVIDIA's data sheet for the SXM part. The tuner's analytic cost model
(``tuning/cost.py``) prices its launches with the same instance.

Not ported: the reference's ``parse_collectives`` and ``_shape_bytes`` read
the collectives and shapes out of XLA's post-SPMD HLO text, which an eager
PyTorch program does not have; the collective sites of the port report
themselves to the counter instead (``op_cost.collective``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class HW:
    """Published peaks of one card (dense rates, no sparsity)."""
    name: str
    hbm_bw: float                 # device-memory bytes/s
    peak_bf16: float              # tensor-core bf16 FLOP/s
    peak_f32: float               # f32 FLOP/s outside the tensor cores
    link_bw: float                # card-to-card bytes/s, one direction

    def peak_flops(self, kernel: str = "") -> float:
        """The peak for the kernel's operands: bf16 x (and a bf16 x int8
        product, exact on the tensor cores) on the tensor cores; the
        decode path's f32 x on ``q8_matvec`` outside them. A program's
        roofline takes the tensor-core peak (``kernel`` empty)."""
        return self.peak_f32 if kernel == "q8_matvec" else self.peak_bf16


#: NVIDIA's data sheet for the H100 SXM part: 3.35 TB/s HBM3, 989 TFLOP/s
#: dense bf16, 67 TFLOP/s f32, and NVLink 4 at 900 GB/s over both
#: directions, 450 GB/s each way
H100 = HW("NVIDIA H100 80GB HBM3", hbm_bw=3.35e12, peak_bf16=989e12,
          peak_f32=67e12, link_bw=450e9)

#: the reference's collective op names
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclass
class CollectiveStats:
    raw_bytes: int = 0                  # sum of result bytes
    wire_bytes: float = 0.0             # ring-model per-device link bytes
    count: int = 0
    by_op: Dict[str, int] = field(default_factory=dict)
    by_op_count: Dict[str, int] = field(default_factory=dict)
    largest: List[Tuple[int, str]] = field(default_factory=list)

    def add(self, op: str, nbytes: int, group_size: int, line: str):
        if op not in COLLECTIVES:
            raise ValueError(f"unknown collective {op!r}; one of "
                             f"{COLLECTIVES}")
        self.raw_bytes += nbytes
        self.count += 1
        self.by_op[op] = self.by_op.get(op, 0) + nbytes
        self.by_op_count[op] = self.by_op_count.get(op, 0) + 1
        n = max(group_size, 2)
        if op == "all-reduce":
            wire = 2.0 * (n - 1) / n * nbytes
        elif op in ("all-gather", "all-to-all"):
            wire = (n - 1) / n * nbytes
        elif op == "reduce-scatter":
            wire = (n - 1) * nbytes      # result is the scattered shard
        else:                            # collective-permute
            wire = float(nbytes)
        self.wire_bytes += wire
        self.largest.append((nbytes, line.strip()[:160]))
        self.largest.sort(reverse=True)
        del self.largest[8:]


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6*N*D)
# ---------------------------------------------------------------------------
def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D (dense) or 6*N_active*D (MoE); D = tokens processed by the
    program (decode cells process global_batch x 1 token). Whisper counts
    encoder and decoder tokens. Training = forward and backward (the full
    6); inference-only cells use 2*N*D (forward only)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        d_tokens = shape.global_batch * shape.seq_len
        if cfg.is_encoder_decoder:
            d_tokens *= 2   # encoder frames + decoder tokens (both seq_len)
        return 6.0 * n_active * d_tokens
    if shape.is_decode:
        return 2.0 * n_active * shape.global_batch
    d_tokens = shape.global_batch * shape.seq_len
    if cfg.is_encoder_decoder:
        d_tokens *= 2
    return 2.0 * n_active * d_tokens


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------
@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_raw_bytes: int
    collective_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    collective_wire_s: float
    bottleneck: str
    model_flops_total: float
    useful_flop_ratio: float            # MODEL_FLOPS / (FLOPs x chips)
    hw: HW = H100
    entry: int = 0                      # the logical entry reported
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    coll_by_op: Dict[str, int] = field(default_factory=dict)
    coll_count: int = 0
    largest_collectives: List[Tuple[int, str]] = field(default_factory=list)

    @property
    def step_s(self) -> float:
        """Roofline step time if the three terms overlap perfectly:
        max(terms), the optimistic bound."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time at the report's card's peak over the bound
        step time: how close the cell is to pure-MFU execution at the
        bound."""
        chips = max(self.chips, 1)
        useful_s = self.model_flops_total / (chips * self.hw.peak_flops())
        return useful_s / self.step_s if self.step_s > 0 else 0.0

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["hw"] = asdict(self.hw)
        d["step_s"] = self.step_s
        d["roofline_fraction"] = self.roofline_fraction
        return d


def roofline_terms(flops_dev: float, bytes_dev: float,
                   coll: CollectiveStats, *, chips: int,
                   hw: HW = H100) -> Tuple[float, float, float, float]:
    """(compute_s, memory_s, collective_s, collective_wire_s) of one
    device's quantities; ``chips`` cancels (the quantities are per
    device), as in the reference."""
    del chips
    compute_s = flops_dev / hw.peak_flops()
    memory_s = bytes_dev / hw.hbm_bw
    collective_s = coll.raw_bytes / hw.link_bw
    collective_wire_s = coll.wire_bytes / hw.link_bw
    return compute_s, memory_s, collective_s, collective_wire_s


def analyze_program(cost, *, arch: str, shape_cfg: ShapeConfig,
                    cfg: ModelConfig, mesh_name: str, chips: int,
                    hw: HW = H100, entry: Optional[int] = None
                    ) -> RooflineReport:
    """The report of one logical entry of a counted program (``cost``, an
    ``op_cost.OpCounter`` that has run it): ``entry``, or the busiest one
    (``cost.busiest()``). ``temp_bytes`` is the peak of what the program
    allocated for it; the caller sets ``arg_bytes``, what the entry held
    before."""
    e = cost.busiest() if entry is None else int(entry)
    flops_dev = float(cost.flops[e])
    bytes_dev = float(cost.bytes[e])
    coll = cost.collectives[e]
    compute_s, memory_s, collective_s, wire_s = roofline_terms(
        flops_dev, bytes_dev, coll, chips=chips, hw=hw)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_cfg)
    ratio = mf / (flops_dev * chips) if flops_dev else 0.0
    return RooflineReport(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_raw_bytes=int(coll.raw_bytes),
        collective_wire_bytes=coll.wire_bytes,
        compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, collective_wire_s=wire_s,
        bottleneck=bottleneck, model_flops_total=mf,
        useful_flop_ratio=ratio, hw=hw, entry=e,
        temp_bytes=int(cost.peak[e]),
        coll_by_op={k: int(v) for k, v in coll.by_op.items()},
        coll_count=int(coll.count),
        largest_collectives=[(int(b), d) for b, d in coll.largest])

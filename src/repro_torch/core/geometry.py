"""Parametric convolution geometry: the k x k generalization of the
paper's 3x3 memory-interlacing scheme.

The paper (Sec. V) assigns one membrane-RAM bank per kernel tap and
derives hazard freedom from a congruence-class column map: events in the
same interlace column are at least one kernel footprint apart, so a
whole column can update its banks in parallel.  Everything about that
construction is a function of the kernel window alone:

* ``n_banks = kh * kw`` RAM banks (one per tap),
* the column map ``s = (i % kh) * kw + (j % kw)`` (congruence classes of
  the event coordinate modulo the window),
* the halo ``(kh // 2, kw // 2)`` of padding a SAME conv needs around
  the membrane tile.

``ConvGeometry`` freezes those three facts plus the stride and is
threaded through the queue builders (``core/aeq.py``), the event-driven
applies (``core/event_conv.py``), the CUDA kernels and their sizing
rules (``kernels/event_conv``) and the planner/scheduler.  The default
instance is the paper's 3x3 stride-1 geometry, and every call site
defaults to it.  A copy of ``repro.core.geometry`` (pure Python): the
port imports nothing of the JAX package.

Only odd windows are supported: the interlaced layout stores membrane
cells in ``kh x kw`` macro-cells and resolves each (column, bank) pair
to a macro-cell offset in {-1, 0, +1}; that single-macro-cell halo
identity holds exactly when the window is odd (centred SAME conv).  The
event pipeline additionally requires stride 1 — a strided event conv
would drop events rather than reuse them, which the paper's architecture
never does — so strided geometries are planned (``out_hw``) but rejected
by the event-driven kernels with a clear error.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """Frozen kernel-window geometry: the single source of truth for
    bank count, column map, and halo sizing across the event pipeline."""

    kh: int = 3
    kw: int = 3
    stride: int = 1

    def __post_init__(self):
        if self.kh < 1 or self.kw < 1:
            raise ValueError(
                f"kernel window must be positive, got ({self.kh}, {self.kw})")
        if self.kh % 2 == 0 or self.kw % 2 == 0:
            raise ValueError(
                "interlaced geometry needs an odd kernel window (centred "
                f"SAME conv), got ({self.kh}, {self.kw})")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")

    # -- derived quantities -------------------------------------------------

    @property
    def n_banks(self) -> int:
        """One membrane-RAM bank per kernel tap: kh * kw."""
        return self.kh * self.kw

    @property
    def halo(self) -> Tuple[int, int]:
        """SAME-conv padding per side: (kh // 2, kw // 2)."""
        return (self.kh // 2, self.kw // 2)

    @property
    def window(self) -> Tuple[int, int]:
        return (self.kh, self.kw)

    def column_index_py(self, i: int, j: int) -> int:
        """Python-int column map (for host-side proofs and tables)."""
        return (i % self.kh) * self.kw + (j % self.kw)

    def column_of(self, i, j):
        """Column map over array coordinates: s = (i % kh) * kw + (j % kw).

        Works on numpy/jax arrays and Python ints alike.
        """
        return (i % self.kh) * self.kw + (j % self.kw)

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        """SAME-padded output geometry under the stride."""
        return (-(-h // self.stride), -(-w // self.stride))

    def padded_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Halo-padded membrane-tile geometry."""
        hh, hw = self.halo
        return (h + 2 * hh, w + 2 * hw)

    def require_event_compatible(self, where: str = "event pipeline"):
        """The event-driven datapath reuses every admitted event across
        the full window, which is only meaningful at stride 1."""
        if self.stride != 1:
            raise ValueError(
                f"{where} requires stride 1 (events are reused across the "
                f"whole {self.kh}x{self.kw} window); got stride="
                f"{self.stride}")

    @classmethod
    def from_kernel_shape(cls, shape) -> "ConvGeometry":
        """Geometry implied by a (kh, kw, ...) kernel array shape."""
        return cls(kh=int(shape[0]), kw=int(shape[1]))

    def describe(self) -> str:
        return (f"{self.kh}x{self.kw}/s{self.stride} "
                f"({self.n_banks} banks)")


#: The paper's geometry — every call site defaults to it, keeping the
#: pre-parametric 3x3 pipeline bit-identical.
GEOM_3X3 = ConvGeometry(3, 3, 1)

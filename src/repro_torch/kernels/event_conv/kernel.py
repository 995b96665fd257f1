"""Wrappers of the event-conv CUDA kernels: ``kernels/csrc/event_conv.cu``
(the batched units replace ``event_conv_pallas_batched`` and
``event_conv_pallas_interlaced_batched``; the single-queue units replace
``event_conv_pallas`` and ``event_conv_pallas_interlaced``) and
``kernels/csrc/event_conv_banked.cu`` (the counterpart of the jnp
``apply_banked_columns_fused``, the conv unit of the banked and
fused-handoff variants).

The four queue wrappers take every input channel's queues of one
(channel block, time step) in one call: coords and valid gain a leading
``C_in`` axis and the kernel is ``(C_in, kh, kw, C)``; the forms without
that axis are the ``C_in = 1`` case.  All four launch one gather kernel;
the interlaced ones add its keep predicate (``ref.interlaced_keep``).
The batched interlaced one takes the tile path instead (one CTA per
membrane tile in shared memory, :func:`tile_path`) where Q is large
enough to fill the card with whole tiles.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``ref.py``) for CPU tensors.  It checks device, dtype, shape and
contiguity first, launches on the current stream without synchronising,
and counts the launch in ``runtime.LAUNCHES``.  The tile is updated in
place when ``out`` is the input tile (the scheduler does this, as the
Pallas kernels aliased their input); otherwise a fresh tensor is
returned.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.geometry import ConvGeometry
from repro_torch.kernels import runtime

from .ref import (event_conv_ref, event_conv_ref_banked,
                  event_conv_ref_batched, event_conv_ref_interlaced,
                  event_conv_ref_interlaced_batched)

#: shared memory one CTA may use on Hopper (227 KB): the budget against
#: which ``ops.autotune_block_e`` / ``autotune_event_par`` and ``plan.py``
#: size queues as JAX sizes them against VMEM (the gather stages no tile)
SMEM_PER_BLOCK = 232448
#: bounds of the gather kernel's packed slot
_MAX_C_IN = 1024
_MAX_SIDE = 2048
#: the tile path of the batched interlaced unit (``launch_tile`` in
#: ``csrc/event_conv.cu``): the largest tile, in bytes, whose CTA holds it
#: beside its list of kept slots in 48 KB of shared memory, and the largest
#: ``event_par`` one thread reads as a group
TILE_MAX_BYTES = 36720
TILE_MAX_PAR = 16
#: the crossover of the two paths at the paper's conv shapes (PERF.md, the
#: crossover table): a tile of at least this many bytes, which the patch
#: gather spreads over many patches, takes the tile path from half a tile
#: per SM; a smaller one from one tile per SM
TILE_LARGE_BYTES = 16384
#: the banked conv's largest pixel patch rows (``banked_patch`` in
#: ``csrc/event_conv_banked.cu`` starts at 8 x 8 and only halves)
_BANKED_PATCH_ROWS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = runtime.load("event_conv")
    if not getattr(lib, "_typed", False):
        lib.event_conv_seq_batched.argtypes = [_P] * 5 + [_I] * 9 + [_P]
        lib.event_conv_seq_batched.restype = _I
        lib.event_conv_interlaced_batched.argtypes = [_P] * 5 + [_I] * 10 + [_P]
        lib.event_conv_interlaced_batched.restype = _I
        lib.event_conv_seq_single.argtypes = [_P] * 5 + [_I] * 8 + [_P]
        lib.event_conv_seq_single.restype = _I
        lib.event_conv_interlaced_single.argtypes = [_P] * 5 + [_I] * 9 + [_P]
        lib.event_conv_interlaced_single.restype = _I
        lib.event_conv_interlaced_tile.argtypes = [_P] * 5 + [_I] * 10 + [_P]
        lib.event_conv_interlaced_tile.restype = _I
        lib._typed = True
    return lib


def _banked_lib():
    lib = runtime.load("event_conv_banked")
    if not getattr(lib, "_typed", False):
        lib.event_conv_banked.argtypes = [_P] * 3 + [_I] * 10 + [_P]
        lib.event_conv_banked.restype = _I
        lib._typed = True
    return lib


def _check(vm_padded, coords, valid, kernel, out, event_par: int, *,
           single: bool = False) -> None:
    """Shapes and dtypes of C_in x Q queues on Q tiles, or (``single``) of
    C_in queues (C_in, E, 2) on one tile (Hp, Wp, C): every queue operand
    and the kernel carry a leading input-channel axis."""
    if vm_padded.ndim != (3 if single else 4):
        want = "vm tile must be (Hp, Wp, C)" if single else \
            "vm tiles must be (Q, Hp, Wp, C)"
        raise ValueError(f"{want}, got shape {tuple(vm_padded.shape)}")
    if vm_padded.dtype not in runtime.DTYPE_CODES:
        raise ValueError(f"unsupported vm dtype {vm_padded.dtype}; expected "
                         f"float32, int16 or int8")
    hp, wp, c = vm_padded.shape[-3:]
    forms = tuple(f"{f} or (C_in, {f[1:]}" for f in
                  ("(E, 2)" if single else "(Q, E, 2)", f"(kh, kw, {c})"))
    if single and (coords.ndim != 3 or coords.shape[-1] != 2):
        raise ValueError(f"coords must be {forms[0]}, got "
                         f"{tuple(coords.shape)}")
    if not single and (coords.ndim != 4 or coords.shape[-1] != 2
                       or coords.shape[-3] != vm_padded.shape[0]):
        raise ValueError(
            f"queue count mismatch: vm has {vm_padded.shape[0]} tiles, "
            f"coords describe {coords.shape[-3] if coords.ndim > 2 else 0} "
            f"queues (coords must be {forms[0]}, got {tuple(coords.shape)})")
    if coords.dtype != torch.int32:
        raise ValueError(f"coords must be int32, got {coords.dtype}")
    if valid.shape != coords.shape[:-1]:
        raise ValueError(f"valid bits shape {tuple(valid.shape)} does not "
                         f"match event coords {tuple(coords.shape)} (coords "
                         f"{forms[0]}, valid without the last axis)")
    if valid.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise ValueError(f"valid must be bool/int8/uint8, got {valid.dtype}")
    if kernel.ndim != 4 or kernel.shape[-1] != c:
        raise ValueError(f"kernel must be {forms[1]}, got "
                         f"{tuple(kernel.shape)}")
    if kernel.shape[0] != coords.shape[0]:
        raise ValueError(
            f"input-channel count mismatch: coords hold {coords.shape[0]} "
            f"input channels' queues, kernel {kernel.shape[0]} slices")
    if kernel.dtype != vm_padded.dtype:
        raise ValueError(f"kernel dtype {kernel.dtype} must match vm dtype "
                         f"{vm_padded.dtype} (cast with .to(vm.dtype))")
    kh, kw = kernel.shape[-3:-1]
    if kh % 2 == 0 or kw % 2 == 0 or hp < kh or wp < kw:
        raise ValueError(f"kernel window ({kh}, {kw}) must be odd and fit "
                         f"the halo-padded tile ({hp}, {wp})")
    e = coords.shape[-2]
    if event_par > 1 and e % event_par:
        raise ValueError(
            f"event stream length E={e} must be a multiple of event_par="
            f"{event_par}: go through ops.event_conv(_batched) or "
            f"aeq.segment_pad, which pad the queues for you")
    if out is not None and (out.shape != vm_padded.shape
                            or out.dtype != vm_padded.dtype
                            or out.device != vm_padded.device):
        raise ValueError("out must match vm in shape, dtype and device")


def check_gather_limits(vm_padded, coords, valid, kernel) -> None:
    """Raise unless the gather can address these (C_in, ...) operands: a
    kept slot packs (input channel, window row, window column) into
    10 + 11 + 11 bits, offsets are 32-bit, coords are read as int2.  The
    launcher calls it before every launch, and the auditor
    (``analysis.hazards``, ``oob-launch-bounds``) on the operand shapes
    every plan hands the wrappers (meta tensors do)."""
    c_in = coords.shape[0]
    hp, wp = vm_padded.shape[-3:-1]
    if (c_in > _MAX_C_IN or max(hp, wp) > _MAX_SIDE
            or max(vm_padded.numel(), valid.numel(), kernel.numel()) >= 2**31):
        raise ValueError(
            f"{c_in} input channels' queues on {tuple(vm_padded.shape)} "
            f"tiles: the conv kernel takes at most {_MAX_C_IN} input "
            f"channels, {_MAX_SIDE} rows or columns and 2**31 elements per "
            f"operand")


def tile_min_q(tile_bytes: int, n_sm: int) -> int:
    """The fewest tiles from which the tile path beats the patch gather
    (:data:`TILE_LARGE_BYTES`): one CTA a tile leaves SMs idle below it,
    where the patch gather spreads a tile over many CTAs."""
    return -(-n_sm // 2) if tile_bytes >= TILE_LARGE_BYTES else n_sm


def tile_path(q: int, tile_bytes: int, n_sm: int, event_par: int,
              single: bool) -> bool:
    """Whether a queue conv launch takes the tile path: the batched
    interlaced unit (not ``single``, ``2 <= event_par <= TILE_MAX_PAR``)
    on tiles of at most :data:`TILE_MAX_BYTES`, from
    :func:`tile_min_q` tiles on a card of ``n_sm`` SMs.  The sequential
    unit has no conflict-free groups and keeps the patch gather."""
    return (not single and 2 <= event_par <= TILE_MAX_PAR
            and tile_bytes <= TILE_MAX_BYTES
            and q >= tile_min_q(tile_bytes, n_sm))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _with_c_in(coords, valid, kernel, *, single: bool):
    """A queue wrapper's operands with the leading input-channel axis;
    the forms without it are the ``C_in = 1`` case.  The shapes are
    checked by :func:`_check` after this."""
    if coords.ndim == (2 if single else 3):
        coords, valid = coords[None], valid[None]
    if kernel.ndim == 3:
        kernel = kernel[None]
    return coords, valid, kernel


def _launch(vm_padded, coords, valid, kernel, out, event_par, *,
            single: bool, tile: Optional[bool] = None):
    """Launch a queue conv unit on (C_in, ...) operands, every input
    channel in one launch: the batched entry on (Q, Hp, Wp, C) tiles, or
    (``single``) the single-queue entry on one (Hp, Wp, C) tile;
    ``event_par > 1`` selects the interlaced keep predicate, and
    :func:`tile_path` the tile path of the batched one (``tile`` pins the
    path, for the card's tests and the crossover timing)."""
    for name, t in (("vm", vm_padded), ("coords", coords), ("valid", valid),
                    ("kernel", kernel), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hp, wp, c = vm_padded.shape[-3:]
    e = coords.shape[-2]
    kh, kw = kernel.shape[-3:-1]
    c_in = coords.shape[0]
    check_gather_limits(vm_padded, coords, valid, kernel)
    if coords.data_ptr() % 8:
        raise ValueError("coords must be 8-byte aligned (int32 pairs)")
    if tile is None:
        tile = tile_path(1 if single else vm_padded.shape[0],
                         hp * wp * c * vm_padded.element_size(),
                         sm_count(vm_padded.device), event_par, single)
    if event_par > 1:
        entry = "event_conv_interlaced_single" if single else \
            "event_conv_interlaced_tile" if tile else \
            "event_conv_interlaced_batched"
        counter = "event_conv_interlaced_single" if single else \
            "event_conv_interlaced"
    else:
        entry = "event_conv_seq_single" if single else "event_conv_seq_batched"
        counter = "event_conv_seq_single" if single else "event_conv_seq"
    args = [vm_padded.data_ptr(), out.data_ptr(), coords.data_ptr(),
            valid.data_ptr(), kernel.data_ptr()]
    args += [c_in] if single else [c_in, vm_padded.shape[0]]
    args += [e, hp, wp, c, kh, kw] + ([event_par] if event_par > 1 else [])
    args += [runtime.DTYPE_CODES[vm_padded.dtype], runtime.stream_ptr(vm_padded)]
    lib = _lib()
    status = getattr(lib, entry)(*args)
    runtime.LAUNCHES[counter] += 1
    if entry == "event_conv_interlaced_tile":
        runtime.LAUNCHES[entry] += 1
    runtime.check(lib, status, entry)
    return out


def _require_par(event_par: int, sequential: str) -> None:
    if event_par < 2:
        raise ValueError(
            f"event_par={event_par}: the interlaced kernel needs >= 2 events "
            f"per group (use {sequential} for the sequential schedule)")


def event_conv_cuda_batched(vm_padded: torch.Tensor, coords: torch.Tensor,
                            valid: torch.Tensor, kernel: torch.Tensor, *,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Apply every input channel's Q event queues, channel by channel and
    each in queue order, to Q halo-padded tiles in one launch.

    vm_padded: (Q, Hp, Wp, C) float32/int16/int8; coords (C_in, Q, E, 2)
    int32 in unpadded space; valid (C_in, Q, E) bool; kernel (C_in, kh,
    kw, C) unrotated, in vm's dtype, kernel[ci] shared by channel ci's
    queues.  The forms without the C_in axis (coords (Q, E, 2), valid (Q,
    E), kernel (kh, kw, C)) are C_in = 1.  Returns the updated tiles
    (``out`` when given; ``out=vm_padded`` updates in place).
    """
    coords, valid, kernel = _with_c_in(coords, valid, kernel, single=False)
    _check(vm_padded, coords, valid, kernel, out, 1)
    if not runtime.use_kernel(vm_padded, coords, valid, kernel):
        res = event_conv_ref_batched(vm_padded, coords, valid, kernel)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(vm_padded)
    return _launch(vm_padded, coords, valid, kernel, out, 1, single=False)


def event_conv_cuda_interlaced_batched(vm_padded: torch.Tensor,
                                       coords: torch.Tensor,
                                       valid: torch.Tensor,
                                       kernel: torch.Tensor, *,
                                       event_par: int,
                                       out: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """Interlace-parallel :func:`event_conv_cuda_batched`: the Pallas
    unit's groups of ``event_par`` same-column events.

    Same contract (coords (C_in, Q, E, 2) or (Q, E, 2), ...), with E a
    multiple of ``event_par``.  Feed it segment-padded queues
    (``aeq.segment_pad``), where every aligned group is column-homogeneous;
    a mixed group runs in queue order, and a coordinate repeated within a
    column-homogeneous group lands once, as in the Pallas kernel.
    Bit-exact vs the sequential kernel on any queue without repeated
    coordinates.  The card takes the path :func:`tile_path` gives.
    """
    return _interlaced_batched(vm_padded, coords, valid, kernel, event_par,
                               out, tile=None)


def event_conv_cuda_interlaced_tile(vm_padded: torch.Tensor,
                                    coords: torch.Tensor,
                                    valid: torch.Tensor,
                                    kernel: torch.Tensor, *, event_par: int,
                                    out: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """:func:`event_conv_cuda_interlaced_batched` on its tile path whatever
    Q: for the kernel audit, which launches every kernel at its own small
    shapes.  Same contract; the card raises where the tile path refuses
    the operands (``event_par`` over :data:`TILE_MAX_PAR`, a tile over
    :data:`TILE_MAX_BYTES`)."""
    return _interlaced_batched(vm_padded, coords, valid, kernel, event_par,
                               out, tile=True)


def _interlaced_batched(vm_padded, coords, valid, kernel, event_par, out, *,
                        tile: Optional[bool]):
    _require_par(event_par, "event_conv_cuda_batched")
    coords, valid, kernel = _with_c_in(coords, valid, kernel, single=False)
    _check(vm_padded, coords, valid, kernel, out, event_par)
    if not runtime.use_kernel(vm_padded, coords, valid, kernel):
        res = event_conv_ref_interlaced_batched(vm_padded, coords, valid,
                                                kernel, event_par=event_par)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(vm_padded)
    return _launch(vm_padded, coords, valid, kernel, out, event_par,
                   single=False, tile=tile)


def event_conv_cuda(vm_padded: torch.Tensor, coords: torch.Tensor,
                    valid: torch.Tensor, kernel: torch.Tensor, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply every input channel's event queue, channel by channel and each
    in queue order, to one halo-padded tile in one launch.

    vm_padded: (Hp, Wp, C) float32/int16/int8; coords (C_in, E, 2) int32
    in unpadded space; valid (C_in, E) bool; kernel (C_in, kh, kw, C)
    unrotated, in vm's dtype.  The forms without the C_in axis are
    C_in = 1.  The kernel spreads the tile's pixels over CTAs.  Returns
    the updated tile (``out`` when given; ``out=vm_padded`` updates in
    place).
    """
    coords, valid, kernel = _with_c_in(coords, valid, kernel, single=True)
    _check(vm_padded, coords, valid, kernel, out, 1, single=True)
    if not runtime.use_kernel(vm_padded, coords, valid, kernel):
        res = event_conv_ref(vm_padded, coords, valid, kernel)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(vm_padded)
    return _launch(vm_padded, coords, valid, kernel, out, 1, single=True)


def event_conv_cuda_interlaced(vm_padded: torch.Tensor, coords: torch.Tensor,
                               valid: torch.Tensor, kernel: torch.Tensor, *,
                               event_par: int,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Interlace-parallel :func:`event_conv_cuda`: coords (C_in, E, 2) or
    (E, 2), ..., with E a multiple of ``event_par``.

    Feed it segment-padded queues (``aeq.segment_pad``); a mixed group
    runs in queue order, and repeated coordinates within a
    column-homogeneous group land once, as in the Pallas kernel.
    """
    _require_par(event_par, "event_conv_cuda")
    coords, valid, kernel = _with_c_in(coords, valid, kernel, single=True)
    _check(vm_padded, coords, valid, kernel, out, event_par, single=True)
    if not runtime.use_kernel(vm_padded, coords, valid, kernel):
        res = event_conv_ref_interlaced(vm_padded, coords, valid, kernel,
                                        event_par=event_par)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(vm_padded)
    return _launch(vm_padded, coords, valid, kernel, out, event_par,
                   single=True)


def banked_min_smem_bytes(hbq: int, wbq: int, geometry: ConvGeometry) -> int:
    """Shared memory the banked conv needs at the least for carriers of
    (HB+2) x (WB+2) macro cells: two staging buffers of one input
    channel's carrier span at the largest pixel patch (8 rows), their
    mbarriers and the bank-offset table (``launch`` in
    ``csrc/event_conv_banked.cu``, whose generic instance shrinks to two
    stages before it refuses the launch)."""
    kh = geometry.kh
    nb = geometry.n_banks
    rows = (_BANKED_PATCH_ROWS + kh - 2) // kh + 3
    span = -(-((nb - 1) * hbq * wbq + rows * wbq + 32) // 16) * 16
    return 2 * span + 16 * 2 + 4 * nb * nb


def check_banked(vm_padded, masks, taps, geometry: ConvGeometry, out=None
                 ) -> tuple[int, ...]:
    """Validate the banked conv's operands (meta tensors do); returns
    (q, hp, wp, c, c_in, HB+2, WB+2).  Raises where a carrier's span
    would not stage in :data:`SMEM_PER_BLOCK`
    (:func:`banked_min_smem_bytes`)."""
    if vm_padded.ndim != 4 or vm_padded.dtype not in runtime.DTYPE_CODES:
        raise ValueError(f"vm tiles must be (Q, Hp, Wp, C) float32/int16/"
                         f"int8, got {tuple(vm_padded.shape)} {vm_padded.dtype}")
    q, hp, wp, c = vm_padded.shape
    kh, kw = geometry.window
    nb = geometry.n_banks
    c_in = masks.shape[0] if masks.ndim else 0
    want = (c_in, q, nb, -(-hp // kh) + 2, -(-wp // kw) + 2)
    if tuple(masks.shape) != want or masks.dtype != torch.bool:
        raise ValueError(f"masks must be {want} bool for {q} tiles of "
                         f"{hp}x{wp} under the {kh}x{kw} geometry, got "
                         f"{tuple(masks.shape)} {masks.dtype}")
    if tuple(taps.shape) != (c_in, nb, nb, c) or taps.dtype != vm_padded.dtype:
        raise ValueError(f"taps must be ({c_in}, {nb}, {nb}, {c}) "
                         f"{vm_padded.dtype}, got {tuple(taps.shape)} "
                         f"{taps.dtype}")
    if out is not None and (out.shape != vm_padded.shape
                            or out.dtype != vm_padded.dtype
                            or out.device != vm_padded.device):
        raise ValueError("out must match vm in shape, dtype and device")
    smem = banked_min_smem_bytes(want[3], want[4], geometry)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"banked conv of {hp}x{wp} tiles under the {kh}x{kw} "
                         f"geometry stages {smem} B of carrier span per CTA, "
                         f"over the {SMEM_PER_BLOCK} B of one block")
    return q, hp, wp, c, c_in, want[3], want[4]


def event_conv_cuda_banked(vm_padded: torch.Tensor, masks: torch.Tensor,
                           taps: torch.Tensor, *, geometry: ConvGeometry,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Apply every input channel's events, given as padded bank occupancy,
    to Q halo-padded tiles in one launch.

    vm_padded (Q, Hp, Wp, C) float32/int16/int8; masks (C_in, Q, n_banks,
    HB+2, WB+2) bool with HB, WB = ceil(Hp/kh), ceil(Wp/kw) — one time
    step of a ``FusedHandoff`` carrier; taps (C_in, n_banks, n_banks, C)
    in vm's dtype (``event_conv.tap_matrix`` per input channel).  Returns
    the updated tiles (``out=vm_padded`` updates in place).
    """
    q, hp, wp, c, c_in, hbq, wbq = check_banked(vm_padded, masks, taps,
                                                geometry, out)
    kh, kw = geometry.window
    if not runtime.use_kernel(vm_padded, masks, taps):
        res = event_conv_ref_banked(vm_padded, masks, taps, geometry)
        return res if out is None else out.copy_(res)
    for name, t in (("vm", vm_padded), ("masks", masks), ("taps", taps),
                    ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out is None:
        out = vm_padded.clone()
    elif out.data_ptr() != vm_padded.data_ptr():
        out.copy_(vm_padded)
    lib = _banked_lib()
    status = lib.event_conv_banked(
        out.data_ptr(), masks.data_ptr(), taps.data_ptr(), q, hp, wp, c,
        c_in, kh, kw, hbq, wbq, runtime.DTYPE_CODES[vm_padded.dtype],
        runtime.stream_ptr(vm_padded))
    runtime.LAUNCHES["event_conv_banked"] += 1
    runtime.check(lib, status, "event_conv_banked")
    return out

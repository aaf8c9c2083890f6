"""The wrapper of the CUDA kernel ``csrc/wkernel_synth.cu``: the
oversampled w-kernel taps of a stack of phase screens as the pruned 2-D
DFT of ``ops.wkernel.tap_window`` (no padded stack, no shifts, no FFT).
It replaces no TPU kernel: the JAX package pads, transforms and extracts
in XLA, as ``ops.wkernel.w_kernel`` still does on the CPU.  The plain
version of its arithmetic is ``ops.wkernel.w_kernel_taps_plain``.

The wrapper takes CUDA tensors only and launches or raises; it never falls
back.  It computes in the screens' precision, complex64 or complex128.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.wkernel import tap_window
from ..utils.timing import launch_counters, launched
from ._build import bind

KERNEL = "wkernel_synth"
# launches of the kernel since the last reset, and the reset
launch_count, reset_launch_count = launch_counters(KERNEL)


def wkernel_synth(screens: torch.Tensor, qpx: int, npix_kern: int,
                  conj: bool = False) -> torch.Tensor:
    """Taps ``[nw, qpx, qpx, s, s]`` of the screens ``[nw, n0, n0]`` (``s
    = npix_kern``) in :func:`ops.wkernel.extract_oversampled`'s layout,
    scaled by qpx²/N² as the padded inverse FFT scales them, conjugated
    where ``conj``: one launch on the current stream (after a launch that
    fills the workspace below, where it is used).

    Any shape: the kernel keeps its table of ``n0·qpx`` twiddles in shared
    memory where it fits, and otherwise in a workspace of that many values
    in device memory, made here.  Raises ``ValueError`` for a dtype other
    than complex64 or complex128, screens that are not ``[nw, n0, n0]``,
    taps outside the padded plane or a CPU tensor, and ``RuntimeError``
    for a launch the card refuses."""
    if screens.dtype not in (torch.complex64, torch.complex128):
        raise ValueError(f"screens must be complex64 or complex128 (got "
                         f"{screens.dtype})")
    if screens.dim() != 3 or screens.shape[1] != screens.shape[2]:
        raise ValueError(f"screens must be [nw, n0, n0] (got "
                         f"{tuple(screens.shape)})")
    nw, n0, s = screens.shape[0], screens.shape[-1], npix_kern
    n, koff, joff = tap_window(n0, qpx, s)
    if not screens.is_cuda:
        raise ValueError("wkernel_synth takes CUDA tensors; on the CPU "
                         "ops.wkernel.w_kernel pads, transforms and extracts")
    out = torch.empty((nw, qpx, qpx, s, s), dtype=screens.dtype,
                      device=screens.device)
    if nw == 0:
        return out
    screens = screens.resolve_conj().contiguous()
    table = torch.empty(n, dtype=screens.dtype, device=screens.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn, err = bind(KERNEL, KERNEL, [vp, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                    vp, vp, vp])
    dev = screens.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(screens.data_ptr(), int(screens.dtype == torch.complex128),
                nw, n0, qpx, s, n, koff, joff, int(conj), table.data_ptr(),
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: {err(rc).decode()} "
                           f"({rc}) at {nw} × {n0}², qpx {qpx}, support {s}")
    launched(KERNEL)
    return out

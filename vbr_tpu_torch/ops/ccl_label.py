"""Connected-component labelling: combined-phase (kernel K2) and
single-phase (kernel K5).

Counterpart of ``vbr_tpu/ops/ccl_pallas.py::label_components_combined``:
8-connected labels of BOTH phases of each padded binary image in one
fixpoint, every pixel carrying the minimum padded linear index of its
own-phase component, capped at ``max_iters`` iterations exactly like the
TPU kernel.  On a CUDA tensor the hand-written kernel
``csrc/ccl_combined.cu`` runs; on a CPU tensor the plain PyTorch version
below (the same iteration, written with Hillis–Steele segmented scans).

``label_components_batched`` is the counterpart of
``ccl_pallas.py::label_components_batched``: foreground only, background =
2³⁰, its own iteration (all 8 neighbours, then scans segmented on the
foreground runs) with the same cap; kernel ``csrc/ccl_label.cu``.

Both kernels take the image as one byte per pixel (a ``torch.bool`` is
passed as it is) and have two routes, chosen in their launchers by shape
alone: one thread-block cluster per image with the labels in shared memory
(``csrc/ccl_common.cuh``) where a band of rows fits, else one CTA per image
with two label buffers in device memory.  ``kernel_route`` says which.
"""

from __future__ import annotations

import ctypes

import torch

from vbr_tpu_torch.ops._cuda import CudaKernel, check, ptr

BIG = 2**30
_DIAGS = ((-1, -1), (-1, 1), (1, -1), (1, 1))

K2 = CudaKernel(
    "ccl_combined.cu", "vbr_ccl_combined",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    deps=("ccl_common.cuh",),
)
K5 = CudaKernel(
    "ccl_label.cu", "vbr_ccl_label",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    deps=("ccl_common.cuh",),
)
_NEIGHBOURS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                    if (dy, dx) != (0, 0))
_routes: dict = {}


def kernel_route(kernel: CudaKernel, H: int, W: int) -> dict:
    """The route ``kernel`` (K2 or K5) takes for (H, W) images on the
    current card, as its launcher decides it: ``{"route": "cluster" |
    "general", "cluster": CTAs per image (0: general), "smem_bytes": shared
    memory per CTA, "active_clusters": clusters the card runs at once}``."""
    key = (kernel.symbol, H, W, torch.cuda.current_device())
    if key not in _routes:
        out = [ctypes.c_int(0) for _ in range(3)]
        fn = kernel.function(
            f"{kernel.symbol}_route",
            [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3)
        kernel.status_ok(fn(H, W, *(ctypes.byref(o) for o in out)),
                         f"{kernel.symbol}_route")
        cluster, smem, active = (o.value for o in out)
        _routes[key] = {"route": "cluster" if cluster else "general",
                        "cluster": cluster, "smem_bytes": smem,
                        "active_clusters": active}
    return _routes[key]


def _launch(kernel: CudaKernel, image: torch.Tensor, name: str,
            max_iters: int):
    """Label a CUDA (B, H, W) 0/1 image with K2 or K5."""
    B, H, W = image.shape
    if image.dtype == torch.bool:
        image = image.contiguous().view(torch.uint8)
    elif image.dtype != torch.uint8:
        image = image.to(torch.uint8)
    image = image.contiguous()
    check(image, name, torch.uint8, (B, H, W), image.device)
    labels = torch.empty((B, H, W), dtype=torch.int32, device=image.device)
    iters = torch.empty(B, dtype=torch.int32, device=image.device)
    with torch.cuda.device(image.device):
        # the cluster route keeps its labels in shared memory
        general = kernel_route(kernel, H, W)["route"] == "general"
        scratch = torch.empty_like(labels) if general else None
        kernel.launch(ptr(image), ptr(labels),
                      ptr(scratch) if general else None, ptr(iters),
                      B, H, W, int(max_iters))
    return labels, iters


def label_components_combined(phase: torch.Tensor, max_iters: int = 64):
    """(B, Hp, Wp) 0/1 phase (Hp % 8 == 0, Wp % 128 == 0; bool, or any
    type holding 0 and 1) → (labels (B, Hp, Wp) i32, iterations run (B,)
    i32)."""
    B, H, W = phase.shape
    if H % 8 or W % 128:
        raise ValueError("padded image dims must be multiples of (8, 128)")
    if phase.device.type == "cpu":
        return label_components_combined_plain(phase, max_iters)
    if phase.device.type != "cuda":
        raise ValueError(f"no kernel for device {phase.device}")
    return _launch(K2, phase, "phase", max_iters)


def _shift(x: torch.Tensor, d: int, dim: int, fill: int) -> torch.Tensor:
    """out[i] = x[i - d] along ``dim``; vacated cells get ``fill``."""
    n = x.shape[dim]
    out = torch.full_like(x, fill)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(dim, d, n - d).copy_(x.narrow(dim, 0, n - d))
    elif d < 0:
        out.narrow(dim, 0, n + d).copy_(x.narrow(dim, -d, n + d))
    else:
        out.copy_(x)
    return out


def _seg_min_scan(v, reset, dim, reverse):
    """Inclusive segmented running min along ``dim``; ``reset`` (0/1)
    starts a new segment (Hillis–Steele over (min, reset) pairs)."""
    r = reset
    d = 1
    while d < v.shape[dim]:
        s = -d if reverse else d
        vs = _shift(v, s, dim, BIG)
        rs = _shift(r, s, dim, 1)
        v = torch.where(r > 0, v, torch.minimum(v, vs))
        r = torch.maximum(r, rs)
        d *= 2
    return v


def label_components_combined_plain(phase: torch.Tensor, max_iters: int = 64):
    """Plain PyTorch version of K2 (any device; the wrapper uses it for
    CPU tensors only)."""
    B, H, W = phase.shape
    ph = phase.to(torch.int32)
    lin = torch.arange(H * W, dtype=torch.int32, device=ph.device)
    labels = lin.reshape(1, H, W).expand(B, H, W).contiguous()
    ph_d = [_shift(_shift(ph, dy, 1, -1), dx, 2, -1) for dy, dx in _DIAGS]
    resets = {
        (dim, rev): (ph != _shift(ph, -1 if rev else 1, dim, -1)).to(torch.int32)
        for dim in (1, 2) for rev in (False, True)
    }
    iters = torch.zeros(B, dtype=torch.int32, device=ph.device)
    active = torch.ones(B, dtype=torch.bool, device=ph.device)
    for _ in range(max_iters):
        nm = labels
        for phs, (dy, dx) in zip(ph_d, _DIAGS):
            sh = _shift(_shift(labels, dy, 1, BIG), dx, 2, BIG)
            nm = torch.minimum(nm, torch.where(phs == ph, sh, BIG))
        l2 = nm
        for dim in (2, 1):  # rows, then columns; forward, then reverse
            for rev in (False, True):
                l2 = _seg_min_scan(l2, resets[(dim, rev)], dim, rev)
        changed = (l2 != labels).flatten(1).any(dim=1)
        iters += active.to(torch.int32)
        active &= changed
        labels = l2  # a converged image is a fixpoint: l2 == labels there
        if not bool(active.any()):
            break
    return labels, iters


def label_components_batched(fg: torch.Tensor, max_iters: int = 64):
    """(B, Hp, Wp) 0/1 foreground (Hp % 8 == 0, Wp % 128 == 0; bool, or
    any type holding 0 and 1) → (labels (B, Hp, Wp) i32: min padded linear
    index of the pixel's 8-connected foreground component, 2³⁰ on the
    background; iterations run (B,) i32)."""
    B, H, W = fg.shape
    if H % 8 or W % 128:
        raise ValueError("padded image dims must be multiples of (8, 128)")
    if fg.device.type == "cpu":
        return label_components_batched_plain(fg, max_iters)
    if fg.device.type != "cuda":
        raise ValueError(f"no kernel for device {fg.device}")
    return _launch(K5, fg, "fg", max_iters)


def label_components_batched_plain(fg: torch.Tensor, max_iters: int = 64):
    """Plain PyTorch version of K5 (any device; the wrapper uses it for
    CPU tensors only)."""
    B, H, W = fg.shape
    fg = fg.to(torch.int32)
    is_fg = fg > 0
    reset = 1 - fg
    lin = torch.arange(H * W, dtype=torch.int32, device=fg.device)
    big = torch.full((), BIG, dtype=torch.int32, device=fg.device)
    labels = torch.where(is_fg, lin.reshape(1, H, W), big)
    iters = torch.zeros(B, dtype=torch.int32, device=fg.device)
    active = torch.ones(B, dtype=torch.bool, device=fg.device)
    for _ in range(max_iters):
        nm = labels
        for dy, dx in _NEIGHBOURS:
            nm = torch.minimum(nm, _shift(_shift(labels, dy, 1, BIG), dx, 2,
                                          BIG))
        l2 = torch.where(is_fg, nm, big)
        for dim in (2, 1):  # rows, then columns; forward, then reverse
            for rev in (False, True):
                l2 = _seg_min_scan(l2, reset, dim, rev)
        changed = (l2 != labels).flatten(1).any(dim=1)
        iters += active.to(torch.int32)
        active &= changed
        labels = l2  # a converged image is a fixpoint: l2 == labels there
        if not bool(active.any()):
            break
    return labels, iters

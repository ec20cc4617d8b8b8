"""Mixture-of-Gaussians background model: frozen apply and MOG training.

Counterpart of ``vbr_tpu/ops/gmm.py``.  Apply side: ``MOGState`` (schema 2:
``var`` is the per-mixture total variance Σv, slots in OpenCV storage
order), ``apply_frozen`` (the full-state reference), and the prefix
compression ``compress_frozen`` + ``apply_frozen_compressed`` that the
per-frame step runs.  Train side: ``MOGTrainState`` (pixel axis minor),
the OpenCV-exact per-frame update ``_update_arrays``, the multi-frame loop
``_train_chunk``, kernel K3 (``train_chunk_kernel``: a whole chunk of
frames per launch, ``csrc/mog_train.cu``, a pixel's used slots in shared
memory for the chunk, found through the carried ``used`` mark) and
``train_mog``.  The reference's other two background models, as eager
tensor code on the state's device: MOG2 (``MOG2Params``, ``MOG2State``,
``init_mog2``, ``_mog2_pass``, ``update_mog2``, ``apply_mog2``,
``train_mog2``, ``extract_mask_mog2``; OpenCV's Zivkovic update, one
rounded f32 operation per JAX operation and every sum over the slots in
slot order, so it equals ``vbr_tpu`` run op by op and does not depend on
the device) and KNN (``KNNParams``, ``KNNState``, ``init_knn``,
``update_knn``, ``apply_knn``, ``train_knn``, ``extract_mask_knn``; its
random slot replacement draws from a ``torch.Generator`` on the state's
device in place of ``jax.random``).

The compressed apply is exact: a pixel is background iff some slot
j < B = min(n_lead, k_fg) matches (‖x − μⱼ‖² < 6.25·Σvⱼ), so only the
first Ke = max(B) slots are kept.  ``compress_frozen`` runs on the host in
float32 numpy with a sequential cumulative weight sum, the order OpenCV
uses, so the per-pixel bound B does not depend on a device's scan order.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from vbr_tpu_torch.ops import color as color_ops
from vbr_tpu_torch.ops._cuda import CudaKernel, check, ptr
from vbr_tpu_torch.utils.config import MOGParams
from vbr_tpu_torch.utils.device import resolve_device

FLT_EPSILON = np.float32(1.1920929e-07)
INITIAL_WEIGHT = 0.05  # OpenCV defaultInitialWeight
DEFAULT_NOISE_SIGMA = 15.0  # OpenCV bgsegm defaultNoiseSigma = 30·0.5

# -fmad=false: the update rounds after every multiply and add, as the JAX
# package does; a fused multiply-add would change the last bit.
K3 = CudaKernel(
    "mog_train.cu", "vbr_mog_train",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
    + [ctypes.c_int, ctypes.c_void_p],
    extra_flags=("-fmad=false",),
)
# Slots of a pixel that K3 keeps in shared memory for a whole chunk (the
# others stay in device memory): CACHE_SLOTS * 2 KB per CTA of 64 pixels.
# Measured fastest of 4-16 on an H100 for a state of ~3 slots per pixel.
K3_CACHE_SLOTS = 7


class MOGState(NamedTuple):
    """Apply-facing mixture state, leading dims = pixel grid (H, W)."""

    weight: torch.Tensor  # (..., K) f32
    mean: torch.Tensor  # (..., K, 3) f32
    var: torch.Tensor  # (..., K) f32 — total variance Σ_channels
    nframes: torch.Tensor  # () int32


class FrozenMOGState(NamedTuple):
    """Decision-sufficient prefix of a frozen MOG model."""

    mean: torch.Tensor  # (..., Ke, 3) f32
    thr: torch.Tensor  # (..., Ke) f32 — 6.25·Σv per slot
    bcount: torch.Tensor  # (...,) i32 — per-pixel decision-slot count B


def _match_d2(x, mean):
    """‖x − μ‖² per slot, summed in the JAX package's order."""
    diff = x[..., None, :] - mean
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
            + diff[..., 2] * diff[..., 2])


def _decision_bound(weight: np.ndarray, bg_ratio: float) -> np.ndarray:
    """Per-pixel B = min(n_lead, k_fg) from (..., K) float32 weights."""
    K = weight.shape[-1]
    invalid = weight < FLT_EPSILON
    n_lead = np.where(invalid.any(axis=-1), np.argmax(invalid, axis=-1), K)
    cumw = np.cumsum(weight, axis=-1, dtype=np.float32)  # sequential
    over = cumw > np.float32(bg_ratio)
    k_fg = np.where(over.any(axis=-1), np.argmax(over, axis=-1) + 1, 0)
    return np.minimum(n_lead, k_fg).astype(np.int32)


def apply_frozen(state: MOGState, frame: torch.Tensor,
                 params: MOGParams) -> torch.Tensor:
    """Full-state frozen inference: (H, W, 3) u8 → (H, W) u8 {0, 255}."""
    x = frame.to(torch.float32)
    w = state.weight
    K = w.shape[-1]
    invalid = w < float(FLT_EPSILON)
    n_lead = torch.where(invalid.any(dim=-1),
                         torch.argmax(invalid.to(torch.int8), dim=-1), K)
    k_idx = torch.arange(K, device=w.device)
    in_prefix = k_idx < n_lead[..., None]
    vt = np.float32(params.match_sigma**2)
    matched = in_prefix & (_match_d2(x, state.mean) < float(vt) * state.var)
    any_match = matched.any(dim=-1)
    first = torch.argmax(matched.to(torch.int8), dim=-1)
    cumw = torch.cumsum(w, dim=-1)
    over = cumw > float(np.float32(params.bg_ratio))
    k_fg = torch.where(over.any(dim=-1),
                       torch.argmax(over.to(torch.int8), dim=-1) + 1, 0)
    is_bg = any_match & (first < k_fg)
    return torch.where(is_bg, 0, 255).to(torch.uint8)


def compress_frozen(state: MOGState, params: MOGParams,
                    k_eff: Optional[int] = None):
    """MOGState → (FrozenMOGState on the state's device, Ke).  ``k_eff``
    forces the prefix length; default = max over pixels of B (≥ 1)."""
    w = state.weight.detach().cpu().numpy().astype(np.float32)
    bcount = _decision_bound(w, params.bg_ratio)
    if k_eff is None:
        k_eff = max(int(bcount.max(initial=0)), 1)
    vt = np.float32(params.match_sigma**2)
    dev = state.weight.device
    return (
        FrozenMOGState(
            mean=state.mean[..., :k_eff, :].to(torch.float32),
            thr=float(vt) * state.var[..., :k_eff].to(torch.float32),
            bcount=torch.from_numpy(bcount).to(dev),
        ),
        k_eff,
    )


def apply_frozen_compressed(fz: FrozenMOGState,
                            frame: torch.Tensor) -> torch.Tensor:
    """Frozen inference on the compressed prefix; (..., 3) u8 → (...) u8
    {0, 255}, bitwise equal to :func:`apply_frozen` on the full state."""
    x = frame.to(torch.float32)
    k_idx = torch.arange(fz.thr.shape[-1], device=fz.thr.device)
    matched = (k_idx < fz.bcount[..., None]) & (_match_d2(x, fz.mean) < fz.thr)
    return torch.where(matched.any(dim=-1), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class MOGTrainState(NamedTuple):
    """Training-time state, pixel axis minor (coalesced across pixels).

    Mirrors OpenCV's MixData fields including the *stored* sort key, which
    is refreshed only on a match and rescaled with the weights every frame.
    """

    weight: torch.Tensor  # (K, HW) f32
    sort_key: torch.Tensor  # (K, HW) f32
    mean: torch.Tensor  # (3, K, HW) f32
    var: torch.Tensor  # (3, K, HW) f32 — per-channel variance
    nframes: torch.Tensor  # () int32
    # (HW,) int32 high-water mark, or None (not known): every slot at or
    # past used[pixel] holds weight 0 and sort key 0 (:func:`slot_high_water`).
    # Kernel K3 reads and raises it in place; the plain version neither
    # needs nor keeps it and returns None.  The JAX package's state has no
    # such field.
    used: Optional[torch.Tensor] = None


def init_state(shape_hw, params: MOGParams, device="cuda") -> MOGState:
    device = resolve_device(device)
    H, W = shape_hw
    K = params.n_mixtures
    return MOGState(
        weight=torch.zeros((H, W, K), dtype=torch.float32, device=device),
        mean=torch.zeros((H, W, K, 3), dtype=torch.float32, device=device),
        var=torch.zeros((H, W, K), dtype=torch.float32, device=device),
        nframes=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_train_state(shape_hw, params: MOGParams,
                     device="cuda") -> MOGTrainState:
    device = resolve_device(device)
    H, W = shape_hw
    K = params.n_mixtures
    hw = H * W
    return MOGTrainState(
        weight=torch.zeros((K, hw), dtype=torch.float32, device=device),
        sort_key=torch.zeros((K, hw), dtype=torch.float32, device=device),
        mean=torch.zeros((3, K, hw), dtype=torch.float32, device=device),
        var=torch.zeros((3, K, hw), dtype=torch.float32, device=device),
        nframes=torch.zeros((), dtype=torch.int32, device=device),
        used=torch.zeros((hw,), dtype=torch.int32, device=device),
    )


def slot_high_water(weight: torch.Tensor,
                    sort_key: torch.Tensor) -> torch.Tensor:
    """(K, HW) weights and sort keys → (HW,) int32: one past the last slot
    whose weight or key is not 0 (0 for an empty pixel).  The update
    leaves every slot at or past it as it is, and only a replacement
    raises it."""
    K = weight.shape[0]
    k1 = torch.arange(1, K + 1, dtype=torch.int32,
                      device=weight.device).reshape(K, 1)
    return torch.where((weight != 0) | (sort_key != 0), k1, 0).amax(dim=0)


def _shift_down(arr: torch.Tensor, k_axis: int) -> torch.Tensor:
    """out[..., j, ...] = arr[..., j-1, ...] along the K axis (j=0 dup)."""
    K = arr.shape[k_axis]
    return torch.cat([arr.narrow(k_axis, 0, 1), arr.narrow(k_axis, 0, K - 1)],
                     dim=k_axis)


def _sum_slots(w: torch.Tensor, axis: int = 0,
               keepdim: bool = False) -> torch.Tensor:
    """Σ over the K axis ``axis``, slot 0 … K−1 in order: the order OpenCV
    and the kernel use (and XLA on a short axis), independent of a
    device's reduction tree."""
    s = w.select(axis, 0)
    for k in range(1, w.shape[axis]):
        s = s + w.select(axis, k)
    return s.unsqueeze(axis) if keepdim else s


def _cumsum_slots(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inclusive prefix sums over the K axis ``axis``, slot by slot."""
    out = [w.select(axis, 0)]
    for k in range(1, w.shape[axis]):
        out.append(out[-1] + w.select(axis, k))
    return torch.stack(out, dim=axis)


def _update_arrays(w, key_s, mu, var, x, alpha, params: MOGParams,
                   compute_fg: bool = True):
    """The OpenCV-exact (bgsegm MOG) per-frame mixture update.

    Shapes: w/key_s (K, P), mu/var (3, K, P), x (3, P) f32, alpha a 0-dim
    f32 tensor.  Returns (w, key, mu, var, fg (P,) bool or None).  Every
    multiply and add is its own rounded float32 operation (no ``addcmul``,
    ``lerp`` or ``rsqrt``), so the result does not depend on the device,
    and the kernel (built without fused multiply-add) equals it bit for
    bit.  The sort key is ``w / sqrt(Σv)`` in IEEE arithmetic, as OpenCV
    computes it.
    """
    K = w.shape[0]
    k_idx = torch.arange(K, device=w.device).reshape(K, 1)

    # OpenCV walks the slots in order and breaks at the first
    # w < FLT_EPSILON: only the leading valid prefix can match.
    invalid = w < float(FLT_EPSILON)
    n_lead_valid = torch.where(invalid, k_idx, K).amin(dim=0)  # (P,)
    in_prefix = k_idx < n_lead_valid

    diff = x[:, None, :] - mu  # (3, K, P)
    d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    varsum = (var[0] + var[1]) + var[2]  # (K, P)
    vt = float(np.float32(params.match_sigma**2))
    matched = in_prefix & (d2 < vt * varsum)
    any_match = matched.any(dim=0)  # (P,)
    c = torch.where(matched, k_idx, K).amin(dim=0)  # first match; 0 if none
    c = torch.where(any_match, c, 0)

    # the matched slot's update, computed dense and picked at c
    min_var = float(np.float32(params.noise_sigma**2))
    w_upd = w + alpha * (1.0 - w)
    mu_upd = mu + alpha * diff
    var_upd = torch.clamp_min(var + alpha * (diff * diff - var), min_var)
    # NEW weight over sqrt(OLD Σvar): the C++ reuses the Σvar of the match
    # gate in the sort key's denominator
    key_upd = w_upd / torch.sqrt(varsum)
    c1 = c[None]
    val_w = torch.gather(w_upd, 0, c1)[0]
    val_key = torch.gather(key_upd, 0, c1)[0]
    c3 = c1.expand(3, -1)[:, None]
    val_mu = torch.gather(mu_upd, 1, c3)[:, 0]  # (3, P)
    val_var = torch.gather(var_upd, 1, c3)[:, 0]

    # single-element upward bubble: the updated slot moves to p = (largest
    # j < c whose stored key >= its new key) + 1; slots p … c−1 move down
    blocker = (k_idx < c) & (key_s >= val_key)
    p = torch.where(blocker, k_idx + 1, 0).amax(dim=0)  # (P,)

    at_p = (k_idx == p) & any_match  # (K, P): broadcasts over channels
    shifted = (k_idx > p) & (k_idx <= c) & any_match

    def bubble(arr, val, k_axis):
        return torch.where(
            at_p, val.unsqueeze(k_axis),
            torch.where(shifted, _shift_down(arr, k_axis), arr))

    w2 = bubble(w, val_w, 0)
    key2 = bubble(key_s, val_key, 0)
    mu2 = bubble(mu, val_mu, 1)
    var2 = bubble(var, val_var, 1)

    # no match: the slot at the break position (first empty, else the last)
    # becomes a fresh mode; var0/sk0 use the DEFAULT noise sigma
    w0 = float(np.float32(INITIAL_WEIGHT))
    var0 = float(np.float32(4.0 * DEFAULT_NOISE_SIGMA**2))
    sk0 = float(np.float32(INITIAL_WEIGHT / (2.0 * DEFAULT_NOISE_SIGMA)))
    r = torch.clamp_max(n_lead_valid, K - 1)  # (P,)
    repl = ~any_match & (k_idx == r)
    w3 = torch.where(repl, w0, w2)
    key3 = torch.where(repl, sk0, key2)
    mu3 = torch.where(repl[None], x[:, None, :], mu2)
    var3 = torch.where(repl[None], var0, var2)

    # weights AND sort keys are rescaled by 1/Σw every training frame
    total = _sum_slots(w3)
    wscale = torch.ones_like(total) / total
    w4 = w3 * wscale
    key4 = key3 * wscale
    if not compute_fg:
        return w4, key4, mu3, var3, None

    # training-mode mask: PRE-bubble hit index vs kForeground
    k_hit = torch.where(any_match, c, r)
    over = _cumsum_slots(w4) > float(np.float32(params.bg_ratio))
    # kForeground stays -1 when the cumulative weight never exceeds the
    # ratio, which makes everything foreground: k_fg = 0
    k_fg = torch.where(over.any(dim=0),
                       torch.where(over, k_idx, K).amin(dim=0) + 1, 0)
    return w4, key4, mu3, var3, k_hit >= k_fg


def _train_step(state: MOGTrainState, x: torch.Tensor, params: MOGParams,
                compute_fg: bool = True):
    """One training step on ``x`` (3, HW) f32 (already colour-converted),
    learning rate 1 / min(nframes, history) (IEEE division).  Returns
    (new_state, fg (HW,) bool — the mask OpenCV's apply() would emit
    during training — or None without ``compute_fg``)."""
    nframes = state.nframes + 1
    n = torch.clamp_max(nframes, int(params.history)).to(torch.float32)
    w, key, mu, var, fg = _update_arrays(
        state.weight, state.sort_key, state.mean, state.var, x,
        torch.ones_like(n) / n, params, compute_fg)
    return MOGTrainState(w, key, mu, var, nframes), fg


def finalize_train_state(ts: MOGTrainState, shape_hw,
                         params: MOGParams) -> MOGState:
    """Training layout → apply-facing ``MOGState`` (Σvar, (H, W, K))."""
    H, W = shape_hw
    K = ts.weight.shape[0]
    varsum = (ts.var[0] + ts.var[1]) + ts.var[2]  # (K, HW)
    return MOGState(
        weight=ts.weight.t().reshape(H, W, K).contiguous(),
        mean=ts.mean.permute(2, 1, 0).reshape(H, W, K, 3).contiguous(),
        var=varsum.t().reshape(H, W, K).contiguous(),
        nframes=ts.nframes,
    )


def _train_chunk(state: MOGTrainState, frames_conv: torch.Tensor,
                 params: MOGParams, emit_masks: bool = False):
    """The plain multi-frame loop: T steps of :func:`_train_step` over
    ``frames_conv`` (T, H, W, 3) u8, already colour-converted.  Returns
    (state, training masks (T, H, W) u8 {0, 255} or None)."""
    T, H, W, _ = frames_conv.shape
    xs = frames_conv.reshape(T, H * W, 3).to(torch.float32).permute(0, 2, 1)
    masks = []
    for t in range(T):
        state, fg = _train_step(state, xs[t], params, compute_fg=emit_masks)
        if emit_masks:
            masks.append(torch.where(fg, 255, 0).to(torch.uint8))
    return state, (torch.stack(masks).reshape(T, H, W) if emit_masks
                   else None)


def train_chunk_plain(state: MOGTrainState, frames_conv: torch.Tensor,
                      params: MOGParams) -> MOGTrainState:
    """Plain PyTorch version of K3 (any device; the wrapper uses it for
    CPU tensors only)."""
    return _train_chunk(state, frames_conv, params)[0]


def train_chunk_kernel(state: MOGTrainState, frames_conv: torch.Tensor,
                       params: MOGParams) -> MOGTrainState:
    """Kernel K3: T frames of the MOG update in one launch, no masks.

    ``frames_conv`` (T, H, W, 3) u8, already colour-converted.  CUDA
    tensors launch ``csrc/mog_train.cu``, which updates the four state
    arrays and ``used`` IN PLACE (the returned state shares them; a state
    that comes with ``used=None`` gets it from :func:`slot_high_water`);
    CPU tensors run :func:`train_chunk_plain`, which allocates new arrays
    and returns ``used=None``."""
    dev = state.weight.device
    if dev.type == "cpu":
        return train_chunk_plain(state, frames_conv, params)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch_k3(state, frames_conv, params, K3_CACHE_SLOTS)


def _launch_k3(state: MOGTrainState, frames_conv: torch.Tensor,
               params: MOGParams, cache_slots: int) -> MOGTrainState:
    """Launch K3 with ``cache_slots`` slots per pixel in shared memory.
    The result does not depend on ``cache_slots``, only the time does."""
    dev = state.weight.device
    T, H, W, _ = frames_conv.shape
    K, hw = state.weight.shape
    check(frames_conv, "frames_conv", torch.uint8, (T, H, W, 3), dev)
    check(state.weight, "weight", torch.float32, (K, H * W), dev)
    check(state.sort_key, "sort_key", torch.float32, (K, hw), dev)
    check(state.mean, "mean", torch.float32, (3, K, hw), dev)
    check(state.var, "var", torch.float32, (3, K, hw), dev)
    check(state.nframes, "nframes", torch.int32, (), dev)
    used = state.used
    if used is None:
        used = slot_high_water(state.weight, state.sort_key)
    check(used, "used", torch.int32, (hw,), dev)
    if T == 0 or hw == 0:
        return state._replace(nframes=state.nframes + T, used=used)
    nframes = torch.empty_like(state.nframes)
    K3.launch(ptr(frames_conv), ptr(state.weight), ptr(state.sort_key),
              ptr(state.mean), ptr(state.var), ptr(state.nframes),
              ptr(nframes), ptr(used), T, K, hw, int(params.history),
              float(np.float32(params.match_sigma**2)),
              float(np.float32(params.noise_sigma**2)), int(cache_slots))
    return state._replace(nframes=nframes, used=used)


def k3_launch_plan(K: int, hw: int,
                   cache_slots: int = K3_CACHE_SLOTS) -> dict:
    """What K3 launches for a (K, hw) state on the current CUDA device:
    cached slots, shared bytes per CTA, CTAs an SM holds, CTAs."""
    fn = K3.function("vbr_mog_train_plan",
                     [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 4)()
    K3.status_ok(fn(K, hw, cache_slots, out), "vbr_mog_train_plan")
    keys = ("cache_slots", "shared_bytes_per_cta", "ctas_per_sm", "ctas")
    return dict(zip(keys, out))


def train_mog(frames, params: MOGParams = MOGParams(), chunk: int = 16,
              return_masks: bool = False, device="cuda"):
    """Train a MOG model over a frame sequence (T, H, W, 3) u8 BGR:
    sequential frames, learning rate 1/min(n, history), optional BGR→HSV.

    Frames go to ``device`` in ``chunk``-frame pieces; each piece is one
    launch of kernel K3 on a CUDA device.  The kernel emits no per-frame
    masks, so ``return_masks=True`` runs the plain step on ``device``
    instead.  Returns the apply-facing :class:`MOGState`; with
    ``return_masks`` also the training masks (what OpenCV's apply() emits
    during training) as a (T, H, W) u8 numpy array.
    """
    dev = resolve_device(device)
    T, H, W, _ = frames.shape
    state = init_train_state((H, W), params, dev)
    mask_parts = []
    for start in range(0, T, chunk):
        part = torch.as_tensor(np.ascontiguousarray(frames[start:start + chunk]),
                               dtype=torch.uint8).to(dev)
        if params.use_hsv:
            part = color_ops.bgr_to_hsv_u8(part)
        if return_masks:
            state, masks = _train_chunk(state, part, params, True)
            mask_parts.append(masks.cpu().numpy())
        else:
            state = train_chunk_kernel(state, part.contiguous(), params)
    final = finalize_train_state(state, (H, W), params)
    if return_masks:
        return final, np.concatenate(mask_parts, axis=0)
    return final


def extract_mask(state: MOGState, frame,
                 params: MOGParams = MOGParams()) -> torch.Tensor:
    """Frozen-model raw foreground mask for a (H, W, 3) u8 BGR frame, on
    the state's device."""
    frame_d = torch.as_tensor(frame, dtype=torch.uint8).to(state.weight.device)
    if params.use_hsv:
        frame_d = color_ops.bgr_to_hsv_u8(frame_d)
    return apply_frozen(state, frame_d, params)


# ---------------------------------------------------------------------------
# MOG2 (Zivkovic adaptive GMM) — the reference's train_MOG2_background_model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MOG2Params:
    n_mixtures: int = 5
    history: int = 500
    # gates on the TOTAL squared distance: ||x−μ||² < T · var, var being the
    # 3-channel-summed variance (OpenCV's)
    var_threshold: float = 16.0  # Tb: background gate
    var_threshold_gen: float = 9.0  # Tg: ownership gate for updates
    bg_ratio: float = 0.9
    var_init: float = 15.0
    var_min: float = 4.0
    var_max: float = 5.0 * 15.0
    complexity_prune: float = 0.05  # cT
    use_hsv: bool = True


class MOG2State(NamedTuple):
    weight: torch.Tensor  # (H, W, K) f32
    mean: torch.Tensor  # (H, W, K, 3) f32
    var: torch.Tensor  # (H, W, K) f32 — TOTAL (3-channel-summed) variance
    nmodes: torch.Tensor  # (H, W) i32 — live mode count
    nframes: torch.Tensor  # () i32


def init_mog2(shape_hw, params: MOG2Params, device="cuda") -> MOG2State:
    device = resolve_device(device)
    H, W = shape_hw
    K = params.n_mixtures
    f32 = dict(dtype=torch.float32, device=device)
    return MOG2State(
        weight=torch.zeros((H, W, K), **f32),
        mean=torch.zeros((H, W, K, 3), **f32),
        var=torch.full((H, W, K), float(np.float32(params.var_init)), **f32),
        nmodes=torch.zeros((H, W), dtype=torch.int32, device=device),
        nframes=torch.zeros((), dtype=torch.int32, device=device),
    )


def _f32(x) -> float:
    """A Python float holding ``x`` rounded to float32."""
    return float(np.float32(x))


def _bubble_k(arr, val, pos, src, on):
    """The mode at ``src`` moved up to ``pos`` with value ``val`` (the
    slots pos … src−1 shift down one) where ``on``; ``arr`` is (..., K)
    or (..., K, 3)."""
    if arr.ndim == pos.ndim + 1:  # (..., K)
        k_axis = arr.ndim - 1
        pp, cc, onb = pos[..., None], src[..., None], on[..., None]
        vv = val[..., None] * torch.ones_like(arr)
    else:  # (..., K, 3)
        k_axis = arr.ndim - 2
        pp, cc = pos[..., None, None], src[..., None, None]
        onb = on[..., None, None]
        vv = val
    j = torch.arange(arr.shape[k_axis], device=arr.device)
    if k_axis == arr.ndim - 2:
        j = j[:, None]
    moved = torch.where(j == pp, vv,
                        torch.where((j > pp) & (j <= cc),
                                    _shift_down(arr, k_axis), arr))
    return torch.where(onb, moved, arr)


def _mog2_pass(w, mu, var, nmodes, x, alphaT, params: MOG2Params):
    """One pass of OpenCV's MOG2 per-pixel loop over every pixel at once
    (``vbr_tpu``'s ``_mog2_pass``, operation for operation): modes in
    storage order, the first within Tg·var owns the sample; visited modes
    decay ``(1−α)w − α·cT`` (the owner gains α) and a visited non-owner
    below α·cT is pruned, which shrinks the loop bound; the owner's mean
    and total variance move by k = α/w'; the owner bubbles up past
    strictly smaller weights; with no owner a new mode (replacing the last
    slot when full) enters with weight α and bubbles; weights are
    renormalized over the visited modes.  ``alphaT`` is a 0-dim f32 tensor;
    0 is the frozen apply (no state change).  Background iff a visited
    mode up to the owner with cumulative weight below ``bg_ratio`` lies
    within Tb·var.

    Returns (w, mu, var, nmodes, bg mask bool)."""
    K = w.shape[-1]
    dev = w.device
    alpha1 = 1.0 - alphaT
    prune_neg = -alphaT * _f32(params.complexity_prune)  # C++ 'prune' (≤ 0)
    Tb = _f32(params.var_threshold)
    Tg = _f32(params.var_threshold_gen)
    TB = _f32(params.bg_ratio)

    k_idx = torch.arange(K, device=dev)
    diff = x[..., None, :] - mu  # (..., K, 3)
    dist2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
    fits_raw = dist2 < Tg * var

    # decayed-unmatched weights and the would-prune flags (the owner is
    # never pruned: its weight gains α > α·cT)
    wd = alpha1 * w + prune_neg
    would_prune = wd < -prune_neg

    def processed_prefix(prunes):
        """Mode k is processed iff k < nmodes − (#prunes among processed
        j < k)."""
        pc = torch.zeros_like(nmodes)
        proc = []
        for j in range(K):
            pj = j < (nmodes - pc)
            proc.append(pj)
            pc = pc + (prunes[..., j] & pj).to(pc.dtype)
        return torch.stack(proc, dim=-1)

    # pass 1 — no owner among earlier modes (true up to the first fit)
    proc1 = processed_prefix(would_prune)
    c = torch.where(fits_raw & proc1, k_idx, K).amin(dim=-1)  # first fit
    any_fit = c < K
    is_hit = (k_idx == c[..., None]) & any_fit[..., None]

    # pass 2 — the owner exempt from pruning
    processed = processed_prefix(would_prune & ~is_hit)

    # final per-slot weights (pre-bubble, pre-normalization)
    wfin = torch.where(is_hit, wd + alphaT, wd)
    pruned = processed & ~is_hit & (wfin < -prune_neg)
    wfin = torch.where(pruned, 0.0, wfin)
    wfin = torch.where(processed, wfin, w)  # truncated tail keeps stale w
    nmodes1 = nmodes - pruned.sum(dim=-1).to(nmodes.dtype)

    # owner content update (the old var in both gate and update)
    w_hit_val = _sum_slots(torch.where(is_hit, wfin, 0.0), -1)
    kk = alphaT / torch.clamp_min(w_hit_val, _f32(1e-30))
    mu_upd = mu + kk[..., None, None] * diff
    var_upd = torch.clamp(var + kk[..., None] * (dist2 - var),
                          _f32(params.var_min), _f32(params.var_max))
    mu1 = torch.where(is_hit[..., None], mu_upd, mu)
    var1 = torch.where(is_hit, var_upd, var)

    # background test before the reordering: visited modes up to the
    # owner, cumulative pre-normalization weight below TB
    wproc = torch.where(processed, wfin, 0.0)
    cum_excl = _cumsum_slots(wproc, -1) - wproc
    visited = processed & (k_idx <= c[..., None])
    bg = (visited & (cum_excl < TB) & (dist2 < Tb * var)).any(dim=-1)

    # owner bubble: strict `<` stop, so the blockers are the modes above
    # with strictly LARGER (decayed) weight
    blocker = (k_idx < c[..., None]) & (wfin > w_hit_val[..., None])
    pos = torch.where(blocker, k_idx + 1, 0).amax(dim=-1)
    hit_mu = _sum_slots(torch.where(is_hit[..., None], mu_upd, 0.0), -2,
                    keepdim=True)
    hit_var = _sum_slots(torch.where(is_hit, var_upd, 0.0), -1)
    w2 = _bubble_k(wfin, w_hit_val, pos, c, any_fit)
    mu2 = _bubble_k(mu1, hit_mu, pos, c, any_fit)
    var2 = _bubble_k(var1, hit_var, pos, c, any_fit)

    total = _sum_slots(wproc, -1)

    # no owner → a new mode (training only: alphaT > 0)
    no_fit = (~any_fit) & (alphaT > 0)
    r = torch.clamp_max(nmodes1, K - 1)
    nmodes2 = torch.where(no_fit, torch.clamp_max(nmodes1 + 1, K), nmodes1)
    is_single = nmodes2 == 1
    one = torch.ones_like(alphaT)
    new_w = torch.where(is_single, one, alphaT)
    total = torch.where(no_fit, torch.where(is_single, one, total + alphaT),
                        total)
    # the new mode written at slot r first (so the shift carries the old
    # content), then bubbled (strict `<` stop again)
    blocker2 = (k_idx < r[..., None]) & (w2 > new_w[..., None])
    pos2 = torch.where(blocker2, k_idx + 1, 0).amax(dim=-1)
    new_mu = x[..., None, :].expand(*mu2.shape[:-2], 1, 3)
    put = no_fit[..., None] & (k_idx == r[..., None])
    var_init = _f32(params.var_init)
    w3 = torch.where(put, new_w[..., None], w2)
    mu3 = torch.where(put[..., None], x[..., None, :], mu2)
    var3 = torch.where(put, var_init, var2)
    w4 = _bubble_k(w3, new_w, pos2, r, no_fit)
    mu4 = _bubble_k(mu3, new_mu, pos2, r, no_fit)
    var4 = _bubble_k(var3, torch.full_like(new_w, var_init), pos2, r, no_fit)

    inv = torch.where(total > 0, torch.ones_like(total) / total, 0.0)
    w5 = w4 * inv[..., None]
    return w5, mu4, var4, nmodes2, bg


def update_mog2(state: MOG2State, frame: torch.Tensor,
                params: MOG2Params) -> MOG2State:
    """One Zivkovic/OpenCV update on a (H, W, 3) u8 frame on the state's
    device, learning rate α = 1/min(2·nframes, history) (as cv2)."""
    nframes = state.nframes + 1
    n = torch.clamp_max(2 * nframes, int(params.history)).to(torch.float32)
    alphaT = torch.ones_like(n) / n
    x = frame.to(torch.float32)
    w, mu, var, nmodes, _ = _mog2_pass(
        state.weight, state.mean, state.var, state.nmodes, x, alphaT, params)
    return MOG2State(weight=w, mean=mu, var=var, nmodes=nmodes,
                     nframes=nframes)


def apply_mog2(state: MOG2State, frame: torch.Tensor,
               params: MOG2Params) -> torch.Tensor:
    """Frozen MOG2 inference (the α = 0 pass) → (H, W) u8 {0, 255}."""
    x = frame.to(torch.float32)
    alpha0 = torch.zeros((), dtype=torch.float32, device=x.device)
    bg = _mog2_pass(state.weight, state.mean, state.var, state.nmodes, x,
                    alpha0, params)[4]
    return torch.where(bg, 0, 255).to(torch.uint8)


def train_mog2(frames, params: MOG2Params = MOG2Params(), chunk: int = 16,
               device="cuda") -> MOG2State:
    """MOG2 over a (T, H, W, 3) u8 BGR sequence on ``device``, frame by
    frame; the frames go up ``chunk`` at a time."""
    dev = resolve_device(device)
    T, H, W, _ = frames.shape
    state = init_mog2((H, W), params, dev)
    for start in range(0, T, chunk):
        part = torch.as_tensor(np.ascontiguousarray(frames[start:start + chunk]),
                               dtype=torch.uint8).to(dev)
        if params.use_hsv:
            part = color_ops.bgr_to_hsv_u8(part)
        for fr in part:
            state = update_mog2(state, fr, params)
    return state


def extract_mask_mog2(state: MOG2State, frame,
                      params: MOG2Params = MOG2Params()) -> torch.Tensor:
    """Frozen MOG2 raw mask of a (H, W, 3) u8 BGR frame on the state's
    device."""
    frame_d = torch.as_tensor(frame, dtype=torch.uint8).to(state.weight.device)
    if params.use_hsv:
        frame_d = color_ops.bgr_to_hsv_u8(frame_d)
    return apply_mog2(state, frame_d, params)


# ---------------------------------------------------------------------------
# KNN background model — the reference's train_KNN_background_model: a
# per-pixel sample history; background iff at least ``k_neighbors`` stored
# samples lie within ``dist2_threshold``.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KNNParams:
    n_samples: int = 21
    k_neighbors: int = 2
    dist2_threshold: float = 400.0
    history: int = 500
    use_hsv: bool = True


class KNNState(NamedTuple):
    samples: torch.Tensor  # (H, W, N, 3) f32
    n_seen: torch.Tensor  # () i32
    generator: torch.Generator  # on the samples' device: slot replacement


def init_knn(shape_hw, params: KNNParams, seed: int = 0,
             device="cuda") -> KNNState:
    device = resolve_device(device)
    H, W = shape_hw
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return KNNState(
        samples=torch.full((H, W, params.n_samples, 3), -1e6,
                           dtype=torch.float32, device=device),
        n_seen=torch.zeros((), dtype=torch.int32, device=device),
        generator=gen,
    )


def update_knn(state: KNNState, frame: torch.Tensor,
               params: KNNParams) -> KNNState:
    """Per-pixel sample update: the first N frames fill the slots round
    robin; afterwards each pixel replaces a uniformly drawn slot with
    probability N/min(n_seen, history).  The draws advance the state's
    generator on every frame."""
    x = frame.to(torch.float32)
    n_seen = state.n_seen + 1
    N = params.n_samples
    H, W = x.shape[:2]
    dev = x.device
    fill_slot = (n_seen - 1) % N
    n = torch.clamp_max(n_seen, int(params.history)).to(torch.float32)
    p_replace = torch.full_like(n, N) / n
    rand_slot = torch.randint(0, N, (H, W), generator=state.generator,
                              device=dev)
    do_replace = torch.rand((H, W), generator=state.generator,
                            device=dev) < p_replace
    filling = n_seen <= N
    slot = torch.where(filling, fill_slot, rand_slot)
    replace = filling | do_replace
    sel = (torch.arange(N, device=dev) == slot[..., None]) & replace[..., None]
    samples = torch.where(sel[..., None], x[..., None, :], state.samples)
    return KNNState(samples=samples, n_seen=n_seen,
                    generator=state.generator)


def apply_knn(state: KNNState, frame: torch.Tensor,
              params: KNNParams) -> torch.Tensor:
    """(H, W) u8 {0, 255}: foreground unless ``k_neighbors`` samples lie
    within ``dist2_threshold`` of the pixel."""
    x = frame.to(torch.float32)
    d = x[..., None, :] - state.samples
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    close = (d2 < params.dist2_threshold).sum(dim=-1)
    return torch.where(close >= params.k_neighbors, 0, 255).to(torch.uint8)


def train_knn(frames, params: KNNParams = KNNParams(), chunk: int = 16,
              seed: int = 0, device="cuda") -> KNNState:
    """KNN over a (T, H, W, 3) u8 BGR sequence on ``device``, frame by
    frame, the replacement draws seeded by ``seed``."""
    dev = resolve_device(device)
    T, H, W, _ = frames.shape
    state = init_knn((H, W), params, seed, dev)
    for start in range(0, T, chunk):
        part = torch.as_tensor(np.ascontiguousarray(frames[start:start + chunk]),
                               dtype=torch.uint8).to(dev)
        if params.use_hsv:
            part = color_ops.bgr_to_hsv_u8(part)
        for fr in part:
            state = update_knn(state, fr, params)
    return state


def extract_mask_knn(state: KNNState, frame,
                     params: KNNParams = KNNParams()) -> torch.Tensor:
    """KNN raw mask of a (H, W, 3) u8 BGR frame on the state's device."""
    frame_d = torch.as_tensor(frame, dtype=torch.uint8).to(
        state.samples.device)
    if params.use_hsv:
        frame_d = color_ops.bgr_to_hsv_u8(frame_d)
    return apply_knn(state, frame_d, params)

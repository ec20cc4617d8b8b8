"""Headless splat renderer for CI and artifact dumps.

The port's counterpart of ``vbr_tpu/viewer/headless.py``: a z-buffered
point splatter that renders the carved voxel cloud (and the floor and the
camera markers) from a pinhole view to an RGB image without a GL context.
``vbr_tpu`` renders with host numpy; here the render is torch on the
cloud's device, so on the card the cloud the step left there is drawn
there and only the image comes down.  One implementation serves the card
and the CPU, and the two give the same bits:

* the projection is f64 elementwise multiplies and adds in column order
  (no matmul, whose reduction order and FMA use differ between cuBLAS,
  CPU BLAS and numpy) with divisions by tensors (CUDA turns a division by
  a host scalar into a multiply by its reciprocal);
* the painter order is a stable sort of ``-z``, so tied depths keep the
  cloud's order (``vbr_tpu``'s ``np.argsort`` is unstable: which of two
  tied splats wins a pixel there depends on its sort);
* within a pass the splat that wins a pixel is the last in painter order
  that passes the z-test, as numpy's fancy assignment keeps the last
  write; it is found by a ``scatter_reduce`` amax of the painter position,
  since ``index_put_`` with repeated indices leaves the winner undefined
  on CUDA.

Everything else is ``vbr_tpu``'s arithmetic: truncation toward zero of
the f64 pixel coordinates, each splat offset clipped to the border, the
z-test of the f64 depth against the f32 z-buffer plus an f32 ``1e-6``
(read as it stood before the pass), the f32 store, and clip, ``× 255``,
truncation for the output.  So the port equals ``vbr_tpu`` wherever the
latter is well defined: everywhere but at pixels where splats of equal
depth meet, and at pixel coordinates beyond the integer range (undefined
casts in numpy, dropped here).
"""

from __future__ import annotations

import binascii
import os
import struct
import zlib

import numpy as np
import torch

from vbr_tpu_torch.utils.device import resolve_device

NEAR = 0.1  # camera-frame depth below which a point is not drawn
Z_EPS = 1e-6  # the z-test's slack, added to the f32 z-buffer in f32


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """World → camera (R, t), host f64 (OpenCV convention: +z forward,
    +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    t = -R @ eye
    return R, t


def _focal(W, fov_deg):
    return float(0.5 * W / np.tan(np.radians(fov_deg) / 2))


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    """``x`` on ``dev``: a tensor as it is, anything else through numpy
    (so a list of floats is f64, as ``np.asarray`` makes it)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(dev) if dtype is None else x.to(dev, dtype)


def _camera_frame(points, R, t):
    """(N, 3) f64 points → camera-frame x, y, z: ``points @ R.T + t`` as
    f64 multiplies and adds in column order."""
    cols = points.unbind(1)

    def row(j):
        acc = cols[0] * float(R[j, 0])
        acc = acc + cols[1] * float(R[j, 1])
        acc = acc + cols[2] * float(R[j, 2])
        return acc + float(t[j])

    return row(0), row(1), row(2)


def _last_writes(pix, cand, n_pix):
    """Per pixel, the largest of ``cand`` (a painter position, -1 for a
    splat that does not write) among the splats at ``pix``: the last write
    of numpy's fancy assignment, -1 where none writes."""
    win = torch.full((n_pix,), -1, dtype=torch.int64, device=pix.device)
    return win.scatter_reduce_(0, pix, cand, reduce="amax")


def render_points(
    positions,  # (N, 3) viewer-space voxel centres
    colors,  # (N, 3) float [0, 1]
    eye=(25.0, 20.0, 25.0),
    target=(0.0, 5.0, 0.0),
    image_hw=(720, 960),
    fov_deg: float = 50.0,
    point_size: int = 3,
    background=(0.08, 0.08, 0.1),
    device="cuda",
) -> torch.Tensor:
    """Z-buffered splat render → (H, W, 3) u8 RGB tensor.

    Tensors stay on their device (``colors`` follows ``positions``); numpy
    arrays and lists go to ``device``, which raises when it names a card
    that is absent (pass ``device="cpu"``)."""
    dev = (positions.device if isinstance(positions, torch.Tensor)
           else resolve_device(device))
    H, W = image_hw
    img = _tensor(np.asarray(background, np.float32), dev).expand(
        H * W, 3).clone()
    zbuf = torch.full((H * W,), float("inf"), dtype=torch.float32,
                      device=dev)
    pts = _tensor(positions, dev, torch.float64).reshape(-1, 3)
    if len(pts) == 0:
        return (img * 255).to(torch.uint8).reshape(H, W, 3)

    R, t = look_at(eye, target)
    x, y, z = _camera_frame(pts, R, t)
    valid = z > NEAR
    x, y, z = x[valid], y[valid], z[valid]
    cols = _tensor(colors, dev, torch.float32).reshape(-1, 3)[valid]
    f = _focal(W, fov_deg)
    uf = x * f / z + W / 2
    vf = y * f / z + H / 2
    # trunc(uf) in [0, W) without the cast of values beyond int32's range
    inb = (uf > -1) & (uf < W) & (vf > -1) & (vf < H)
    u, v = uf[inb].to(torch.int32), vf[inb].to(torch.int32)
    z, cols = z[inb], cols[inb]
    n = len(z)

    if n:
        # far-to-near painter order, then a z-test per splat offset
        order = torch.sort(-z, stable=True).indices
        u, v, z, cols = u[order], v[order], z[order], cols[order]
        painter = torch.arange(n, device=dev)
        eps = torch.full((), Z_EPS, dtype=torch.float32, device=dev)
        r = point_size // 2
        for du in range(-r, r + 1):
            for dv in range(-r, r + 1):
                uu = (u + du).clamp(0, W - 1).to(torch.int64)
                vv = (v + dv).clamp(0, H - 1).to(torch.int64)
                pix = vv * W + uu
                better = z < zbuf[pix] + eps
                win = _last_writes(pix, torch.where(better, painter, -1),
                                   H * W)
                hit = win >= 0
                w = win.clamp(min=0)
                img = torch.where(hit[:, None], cols[w], img)
                zbuf = torch.where(hit, z[w].to(torch.float32), zbuf)
    return (img.clamp(0, 1) * 255).to(torch.uint8).reshape(H, W, 3)


def render_floor_and_cameras(
    img,
    floor_positions,
    floor_colors,
    cam_positions,
    cam_colors,
    eye=(25.0, 20.0, 25.0),
    target=(0.0, 5.0, 0.0),
    fov_deg: float = 50.0,
):
    """Overlay the checkerboard floor tiles and camera markers, in place on
    ``img``, the (H, W, 3) u8 tensor of ``render_points`` (the points go to
    its device).  Floor tiles are one pixel each, coloured
    ``floor_colors × 200`` and drawn over the voxels with no z-test (the
    last tile at a pixel wins); each camera is a 7×7 square of
    ``cam_colors × 255``, drawn in camera order when it lies 3 pixels
    inside the border."""
    dev = img.device
    H, W, _ = img.shape
    flat = img.view(H * W, 3)
    R, t = look_at(eye, target)
    f = _focal(W, fov_deg)

    def project(pts):
        x, y, z = _camera_frame(_tensor(pts, dev, torch.float64)
                                .reshape(-1, 3), R, t)
        ok = z > NEAR
        zs = torch.where(ok, z, torch.ones_like(z))
        return x * f / zs + W / 2, y * f / zs + H / 2, ok

    uf, vf, ok = project(floor_positions)
    inb = ok & (uf > -1) & (uf < W) & (vf > -1) & (vf < H)
    if len(inb):
        zero = torch.zeros_like(uf)
        u = torch.where(inb, uf, zero).to(torch.int64)
        v = torch.where(inb, vf, zero).to(torch.int64)
        cand = torch.where(inb, torch.arange(len(inb), device=dev), -1)
        win = _last_writes(v * W + u, cand, H * W)
        tile = (_tensor(floor_colors, dev).reshape(-1, 3) * 200).to(
            torch.uint8)
        flat.copy_(torch.where((win >= 0)[:, None], tile[win.clamp(min=0)],
                               flat))

    if isinstance(cam_colors, torch.Tensor):
        cam_colors = cam_colors.cpu().numpy()
    uf, vf, ok = project(cam_positions)
    keep = ok & (uf >= 3) & (uf < W - 3) & (vf >= 3) & (vf < H - 3)
    zero = torch.zeros_like(uf)
    where = torch.stack([keep.to(torch.int64),
                         torch.where(keep, uf, zero).to(torch.int64),
                         torch.where(keep, vf, zero).to(torch.int64)], 1)
    for k, (draw, u, v) in enumerate(where.tolist()):
        if draw:
            c = (np.asarray(cam_colors[k]) * 255).astype(np.uint8)
            img[v - 3:v + 4, u - 3:u + 4] = torch.from_numpy(c).to(dev)
    return img


def save_png(path: str, img):
    """Write an (H, W, 3) u8 RGB image, or an (H, W) u8 grey one (tensor or
    array), as an 8-bit PNG with the standard library (zlib, every row
    filter 0), which any PNG decoder reads back."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    img = np.ascontiguousarray(img)
    grey = img.ndim == 2
    if img.dtype != np.uint8 or not (grey or img.ndim == 3
                                     and img.shape[2] == 3):
        raise ValueError(f"save_png wants (H, W, 3) u8 RGB or (H, W) u8 "
                         f"grey, got {img.shape} {img.dtype}")
    H, W = img.shape[:2]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1)],
                         axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", binascii.crc32(kind + body)))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8,
                                             0 if grey else 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))

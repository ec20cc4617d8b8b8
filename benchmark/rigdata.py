"""The seeded inputs of a cell: the rig's cameras, one background sequence
per camera and the rig video, made on the device from ``--seed`` and handed
to the program and the reference as host arrays, as a capture card
delivers frames.

The painting follows the rig's configuration (``image_hw``, ``cameras``,
``background``, ``subject``) and the traffic mix (``video_frames``,
``walk_px``, ``bob_px``, ``bob_cycles``, ``speckle``, ``video_noise``,
``burst_every``, ``burst_speckle``):

  * each camera's background is 16-pixel blocks of one colour in [80, 170]
    per channel with ±6 per pixel;
  * a background frame adds one of ``noise_fields`` fields of ±4 noise
    (3 % of its pixels +50) to it, rolled along the rows by a seeded
    offset;
  * video frame t paints each camera's silhouette, rolled by the walk
    (``walk_px`` across the clip) and the bob (``bob_px`` up and down,
    ``bob_cycles`` times), plus ``speckle`` seeded pixels, in a dark
    texture over the background; with ``video_noise`` it then adds one of
    the same ±4 fields without their bright pixels (the sensor's noise),
    rolled by a seeded offset;
  * a burst frame (``is_burst``) adds ``burst_speckle`` more seeded pixels
    to one camera, in turn: more foreground components than the program's
    device cleanup holds, so the program redoes that frame exactly.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

CHUNK = 32  # video frames painted per batch of device work


def silhouettes(root, config, image_hw) -> np.ndarray:
    """(C, H, W) bool: the subject's silhouettes, subsampled to
    ``image_hw``."""
    with np.load(f"{root}/{config['subject']['silhouettes']}") as f:
        sils = f["silhouettes"]
    H0, W0 = sils.shape[1:]
    ys = np.arange(image_hw[0]) * H0 // image_hw[0]
    xs = np.arange(image_hw[1]) * W0 // image_hw[1]
    return sils[:, ys][:, :, xs]


def texture(image_hw, period, device) -> torch.Tensor:
    """(H, W, 3) u8 BGR: the subject's dark texture (x mod p, y mod p, 0)."""
    H, W = image_hw
    yy, xx = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return torch.stack([xx % period, yy % period, torch.zeros_like(xx)],
                       -1).to(torch.uint8)


def is_burst(traffic, t) -> bool:
    """Whether video frame ``t`` carries a burst of speckle."""
    every = int(traffic.get("burst_every", 0))
    return every > 0 and t % every == every // 2


def walk(traffic, t) -> tuple:
    """(dy, dx) of the subject in video frame ``t``."""
    ph = t / max(traffic["video_frames"] - 1, 1)
    dx = int(round(traffic["walk_px"] * (ph - 0.5)))
    dy = int(round(traffic["bob_px"]
                   * math.sin(2 * math.pi * traffic["bob_cycles"] * ph)))
    return dy, dx


def make(root, config, traffic, seed, device):
    """The cell's inputs from ``seed``: a namespace with ``cameras``,
    ``image_hw``, ``background`` (C, T, H, W, 3) u8 and ``video`` (F, C,
    H, W, 3) u8, host numpy."""
    image_hw = tuple(config["image_hw"])
    H, W = image_hw
    bgc = config["background"]
    T = int(bgc["frames"])
    F = int(traffic["video_frames"])
    cams = config["cameras"]
    C = len(cams)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    b = int(bgc["block_px"])
    blocks = randint(bgc["level_lo"], bgc["level_hi"] + 1,
                     (C, -(-H // b), -(-W // b), 3))
    bg = blocks.repeat_interleave(b, 1).repeat_interleave(b, 2)[:, :H, :W]
    bg = (bg + randint(-bgc["jitter"], bgc["jitter"] + 1, (C, H, W, 3))
          ).clamp(0, 255).to(torch.int16)
    nf = int(bgc["noise_fields"])
    sensor = randint(-bgc["noise"], bgc["noise"] + 1,
                     (nf, C, H, W, 3)).to(torch.int16)
    bright = torch.rand((nf, C, H, W), generator=g, device=device) < float(
        bgc["bright_share"])
    noise = sensor.clone()
    noise[bright] = int(bgc["bright"])
    picks = randint(0, nf, (T,)).tolist()
    shifts = randint(0, W, (T,)).tolist()
    background = np.empty((C, T, H, W, 3), np.uint8)
    for t0 in range(0, T, CHUNK):
        part = torch.stack([
            (bg + torch.roll(noise[picks[t]], shifts[t], dims=2)).clamp(0, 255)
            for t in range(t0, min(T, t0 + CHUNK))], dim=1).to(torch.uint8)
        background[:, t0:t0 + part.shape[1]] = part.cpu().numpy()
    del noise, bright

    sils = torch.from_numpy(silhouettes(root, config, image_hw)).to(device)
    tex = texture(image_hw, config["subject"]["texture_period"], device)
    n_sp = int(traffic["speckle"])
    sp_y = randint(0, H, (F, C, n_sp))
    sp_x = randint(0, W, (F, C, n_sp))
    cam_idx = torch.arange(C, device=device)[:, None].expand(C, n_sp)
    n_burst = int(traffic.get("burst_speckle", 0))
    burst_y = randint(0, H, (F, n_burst))
    burst_x = randint(0, W, (F, n_burst))
    vpicks = randint(0, nf, (F,)).tolist()
    vshifts = randint(0, W, (F,)).tolist()
    noisy = bool(traffic.get("video_noise", False))
    bg_u8 = bg.to(torch.uint8)
    video = np.empty((F, C, H, W, 3), np.uint8)
    for t0 in range(0, F, CHUNK):
        part = []
        for t in range(t0, min(F, t0 + CHUNK)):
            sil = torch.roll(sils, walk(traffic, t), dims=(1, 2))
            sil[cam_idx, sp_y[t], sp_x[t]] = True
            if is_burst(traffic, t):
                c = t // int(traffic["burst_every"]) % C
                sil[c, burst_y[t], burst_x[t]] = True
            frame = torch.where(sil[..., None], tex, bg_u8)
            if noisy:
                frame = (frame.to(torch.int16) + torch.roll(
                    sensor[vpicks[t]], vshifts[t], dims=2)).clamp(0, 255)
            part.append(frame.to(torch.uint8))
        video[t0:t0 + len(part)] = torch.stack(part).cpu().numpy()
    return SimpleNamespace(cameras=cams, image_hw=image_hw,
                           background=background, video=video)

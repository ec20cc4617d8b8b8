"""The rank worker of ``tests/test_torch_parallel.py``, and the scenes both
sides of its comparisons draw from.  It holds no tests.

    python tests/test_torch_parallel_ranks.py WORKDIR RANK WORLD

runs, in one process of a WORLD-rank gloo group (a ``FileStore`` in
WORKDIR), every case of ``WORKDIR/cases.json`` whose ``world`` is WORLD,
on the CPU, and writes what each case returned on this rank to
``WORKDIR/w{WORLD}_rank{RANK}.npz``.  It imports neither JAX nor
``vbr_tpu``, so each spawned rank starts without them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

H, W = 64, 96  # the small rig of tests/test_parallel_pallas.py
C = 4
KE = 2
FIG_THR = (40.0, 40.0, 60.0, 40.0)
INNER_THR = (8.0, 8.0, 12.0, 8.0)
GRID_BOUNDS = dict(x_min=-900, x_max=1100, y_min=-1050, y_max=950,
                   z_min=-1700, z_max=300)
ORDERS = (None, "strided", "cost")


def grid(n=32):
    from vbr_tpu_torch.utils.config import GridConfig

    return GridConfig(nx=n, ny=n, nz=n, **GRID_BOUNDS)


def hsv(bgr: np.ndarray) -> np.ndarray:
    from vbr_tpu_torch.ops.color import bgr_to_hsv_u8

    return bgr_to_hsv_u8(torch.from_numpy(bgr)).numpy()


def production_scene(frames_n, seed=0):
    """The compressed frozen state (mean, thr, bcount) and (F, C, H, W, 3)
    frames of tests/test_parallel_pallas.py: background = the state's
    means, a moving bright square = foreground, a small blob below the
    figure threshold."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 200, size=(C, H, W, 3), dtype=np.uint8)
    frames = []
    for f in range(frames_n):
        fr = bg.copy()
        y0, x0 = 12 + 6 * f, 20 + 9 * f
        fr[:, y0:y0 + 28, x0:x0 + 30] = 255
        fr[:, 5:9, 60:64] = 250
        frames.append(fr)
    mean = np.zeros((C, H, W, KE, 3), np.float32)
    mean[:, :, :, 0, :] = hsv(bg)
    mean[:, :, :, 1, :] = -1000.0  # never matches
    thr = np.full((C, H, W, KE), 3 * 12.0**2, np.float32)
    bcount = np.ones((C, H, W), np.int32)
    return (mean, thr, bcount), np.stack(frames)


def runner_scene(seed=5):
    """Per-camera MOG states (weight, mean, var) numpy and four 2-frame
    batches: three with a bright figure in a different place per batch
    and frame, and one whose second frame is a speckle of isolated dots
    (more components than the device tables hold: an overflow)."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 200, size=(C, H, W, 3), dtype=np.uint8)
    weight = np.zeros((C, H, W, 2), np.float32)
    weight[..., 0] = 1.0
    mean = np.full((C, H, W, 2, 3), -1000.0, np.float32)
    mean[..., 0, :] = hsv(bg)
    var = np.full((C, H, W, 2), 60.0, np.float32)
    batches = []
    for b, (y0, x0) in enumerate(((14, 22), (18, 30), (8, 26), (14, 22))):
        batch = np.stack([bg.copy(), bg.copy()])
        for f in range(2):
            batch[f, :, y0 + 2 * f:y0 + 2 * f + 30, x0:x0 + 38] = 255
        if b == 3:
            batch[1, :, ::3, ::3] = 255
        batches.append(batch)
    return (weight, mean, var), batches


def runner_mask_params():
    from vbr_tpu_torch.utils.config import DEFAULT_MASK_PARAMS

    return tuple(dataclasses.replace(p, figure_threshold=40.0,
                                     inner_threshold=8.0)
                 for p in DEFAULT_MASK_PARAMS[:C])


def table_scene(seed=3):
    """Inputs of the sharded carve and pipeline steps on a 16³ grid: two
    frames of masks and BGR images, the pipeline's (frames, weight, mean,
    var) with 4 mixtures (the second frame rolled off the model)."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((2, C, H, W), np.uint8)
    for f in range(2):
        for c in range(C):
            y0, x0 = rng.integers(4, 24), rng.integers(10, 40)
            masks[f, c, y0:y0 + 32, x0:x0 + 40] = 255
    masks |= (rng.random(masks.shape) < 0.05).astype(np.uint8) * 255
    images = rng.integers(0, 256, (2, C, H, W, 3), dtype=np.uint8)
    K = 4
    base = rng.integers(0, 256, (C, H, W, 3)).astype(np.float32)
    weight = np.zeros((C, H, W, K), np.float32)
    weight[..., 0], weight[..., 1] = 0.7, 0.3
    mean = rng.uniform(0, 255, (C, H, W, K, 3)).astype(np.float32)
    mean[..., 0, :] = base
    var = rng.uniform(100, 700, (C, H, W, K)).astype(np.float32)
    frames = np.stack([base.astype(np.uint8),
                       np.roll(base.astype(np.uint8), 20, axis=2)])
    return masks, images, (frames, weight, mean, var)


PIPE_FIG, PIPE_INNER = (300.0,) * C, (12.0,) * C


def volume_scene(name):
    """(volume, extract kwargs) of the extraction cases; nx = 24 divides 2
    and 3 shards, 25 neither."""
    rng = np.random.default_rng(11)
    if name == "tetrahedra":
        vol = np.zeros((24, 20, 20), bool)
        g = np.arange(24)[:, None, None]
        vol[(np.abs(g - 11) < 8) & (np.arange(20)[None, :, None] % 19 > 3)
            & (np.arange(20)[None, None, :] > 6)] = True
        return vol, {}
    if name == "cubes":
        vol = rng.uniform(size=(24, 12, 12)) < 0.4
        vol[0] = vol[-1] = False
        return vol, {"algorithm": "cubes"}
    if name == "capacity":
        vol = np.zeros((24, 12, 12), bool)
        vol[4:20, 2:10, 2:10] = True
        return vol, {"capacity": 8}
    if name == "scaled":
        vol = np.zeros((24, 10, 10), bool)
        vol[3:18, 2:8, 3:9] = True
        return vol, {"origin": (10, 20, 30), "spacing": (2, 2, 2)}
    if name == "field":
        return rng.uniform(size=(24, 10, 10)).astype(np.float32), {
            "algorithm": "cubes"}
    if name == "undivided":
        vol = np.zeros((25, 10, 10), bool)
        vol[3:20, 2:8, 3:9] = True
        return vol, {}
    raise ValueError(name)


VOLUMES = ("tetrahedra", "cubes", "capacity", "scaled", "field", "undivided")


def cases():
    """Every spawned case: (world, id, spec)."""
    out = []
    for shape, frames_n in (((1, 2, 2), 1), ((2, 2, 1), 2), ((1, 4, 1), 1),
                            ((1, 1, 3), 1)):
        sup = (2, 2, 4) if shape == (1, 1, 3) else (1, 1, 1)
        for order in ORDERS:
            out.append((int(np.prod(shape)),
                        f"prod_{'x'.join(map(str, shape))}_{order}",
                        {"kind": "production", "shape": shape, "sup": sup,
                         "frames_n": frames_n, "order": order}))
    for order in ("strided", "cost", "rebalance"):
        out.append((4, f"runner_{order}", {"kind": "runner",
                                           "order": order}))
    for shape in ((2, 2, 1), (1, 2, 2)):
        for kind in ("carve", "pipeline", "pipeline_clean"):
            out.append((4, f"{kind}_{'x'.join(map(str, shape))}",
                        {"kind": kind, "shape": shape}))
    for world in (2, 3):
        for name in VOLUMES:
            out.append((world, f"mesh{world}_{name}",
                        {"kind": "mesh", "volume": name}))
    return out


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------


def port_masks(fz, frames_one, mask_params, fig=FIG_THR, inner=INNER_THR):
    """The port's single-device mask stage of one (C, H, W, 3) frame."""
    from vbr_tpu_torch.ops import ccl, gmm
    from vbr_tpu_torch.pipelines import background

    raw = background.raw_masks_batched_fz(
        gmm.FrozenMOGState(*(torch.from_numpy(a) for a in fz)),
        torch.from_numpy(frames_one), mask_params)
    cleaned, _ = ccl.clean_masks_batched(raw, fig, inner)
    return background.finalize_masks_batched(cleaned, mask_params)


def run_production(spec):
    from vbr_tpu_torch.ops import carve_blocked, gmm
    from vbr_tpu_torch.parallel import carve_sharded, pallas_sharded
    from vbr_tpu_torch.utils.config import DEFAULT_MASK_PARAMS
    from vbr_tpu_torch.utils.synthetic import synthetic_cameras

    shape, order_mode = tuple(spec["shape"]), spec["order"]
    if shape == (1, 1, 3):  # make_carve_mesh would give cam = 3
        mesh = carve_sharded.carve_mesh(shape, "cpu")
    else:
        mesh = carve_sharded.make_carve_mesh(
            None, num_cameras=shape[1], frame_batch=shape[0], device="cpu")
    assert mesh.shape == shape, mesh.shape
    cams = synthetic_cameras(C, image_hw=(H, W), f=80.0)
    btab = carve_blocked.build_block_tables(
        cams, grid(), (H, W), sub=(8, 8, 8), sup=tuple(spec["sup"]),
        color_camera=1, device="cpu")
    fz, frames = production_scene(spec["frames_n"])
    mp = DEFAULT_MASK_PARAMS[:C]
    S = shape[1] * shape[2]
    order = None
    if order_mode is not None:
        costs = None
        if order_mode == "cost":
            costs = pallas_sharded.superblock_costs(
                btab, port_masks(fz, frames[0], mp), 4)
        order = pallas_sharded.superblock_order(btab.nsuper, S, order_mode,
                                                costs=costs)
    st = pallas_sharded.shard_block_tables(mesh, btab, order=order)
    step = pallas_sharded.sharded_production_step(mesh, use_hsv=True,
                                                  views_threshold=4)
    placed = pallas_sharded.place_production_inputs(
        mesh, frames, gmm.FrozenMOGState(*(torch.from_numpy(a) for a in fz)),
        FIG_THR, INNER_THR, pallas_sharded.mask_flags_array(mp))
    occ_b, col_b, ovf = step(*placed, st.tables)
    out = {"occ_b": occ_b, "col_b": col_b, "ovf": ovf,
           "nsuper_pad": np.asarray(st.nsuper_pad)}
    if order is not None:
        out["order"] = order
    return out


def port_model():
    from vbr_tpu_torch.models.visual_hull import VisualHull
    from vbr_tpu_torch.ops.gmm import MOGState
    from vbr_tpu_torch.utils.config import MOGParams, RigConfig
    from vbr_tpu_torch.utils.synthetic import synthetic_cameras

    (weight, mean, var), batches = runner_scene()
    model = VisualHull(synthetic_cameras(C, image_hw=(H, W), f=80.0), grid(),
                       RigConfig(image_height=H, image_width=W),
                       mask_params=runner_mask_params(), device="cpu")
    model.bg_states = [
        MOGState(*(torch.from_numpy(a[c]) for a in (weight, mean, var)),
                 nframes=torch.tensor(6, dtype=torch.int32))
        for c in range(C)]
    model.mog_params = [MOGParams()] * C
    return model, batches


def run_runner(spec):
    from vbr_tpu_torch.parallel import carve_sharded

    mesh = carve_sharded.make_carve_mesh(None, num_cameras=2, frame_batch=2,
                                         device="cpu")
    assert mesh.shape == (2, 2, 1), mesh.shape
    model, batches = port_model()
    out = {}
    if spec["order"] == "rebalance":
        runner = model.sharded_runner(mesh, order="contiguous",
                                      rebalance_every=1)
        out["occ_a"], out["col_a"] = runner(batches[0])
        out["replaced"] = np.asarray(runner.rebalance(batches[0][0],
                                                      min_gain=0.0))
        out["mode_cost"] = np.asarray(runner.mode == "cost")
        out["costs"], out["order"] = runner.costs, runner.order
        out["imbalance"] = np.asarray(runner.imbalance())
        out["shard_costs"] = runner.shard_costs()
        out["occ_b"], out["col_b"] = runner(batches[0])  # auto rebalance
        out["order_after"] = runner.order
        return out
    runner = model.sharded_runner(
        mesh, order=spec["order"],
        costing_frames=batches[0][0] if spec["order"] == "cost" else None)
    out["order"] = runner.order
    for i, (occ, col) in enumerate(map(runner, batches)):
        out[f"call{i}_occ"], out[f"call{i}_col"] = occ, col
    for i, (occ, col) in enumerate(runner.stream(iter(batches), depth=2)):
        out[f"stream{i}_occ"], out[f"stream{i}_col"] = occ, col
    try:
        runner(batches[0][:1])
    except ValueError as e:
        out["short_batch_refused"] = np.asarray("data-axis" in str(e))
    return out


def port_tables():
    from vbr_tpu_torch.ops import carve
    from vbr_tpu_torch.utils.synthetic import synthetic_cameras

    cams = synthetic_cameras(C, image_hw=(H, W), f=80.0)
    return carve.build_projection_tables(cams, grid(16), (H, W),
                                         accelerate=False, device="cpu")


def run_tables(spec):
    from vbr_tpu_torch.parallel import carve_sharded, pipeline_sharded
    from vbr_tpu_torch.utils.config import MOGParams

    mesh = carve_sharded.carve_mesh(tuple(spec["shape"]), "cpu")
    tables = port_tables()
    masks, images, (frames, weight, mean, var) = table_scene()
    if spec["kind"] == "carve":
        step = carve_sharded.sharded_carve_step(mesh, views_threshold=4,
                                                color_camera=1)
        occ, col = step(*carve_sharded.shard_inputs(
            mesh, masks, images, tables.valid, tables.lin_idx))
        return {"occ": occ, "col": col}
    clean = spec["kind"] == "pipeline_clean"
    p = MOGParams(use_hsv=False, n_mixtures=4)
    step = pipeline_sharded.sharded_pipeline_step(
        mesh, views_threshold=3, mog_params=p, clean=clean)
    thr = dict(fig_thr=PIPE_FIG, inner_thr=PIPE_INNER) if clean else {}
    occ = step(*pipeline_sharded.place_pipeline_inputs(
        mesh, frames, weight, mean, var, tables.valid, tables.lin_idx,
        **thr))
    return {"occ": occ}


def run_mesh(spec, world):
    from torch.distributed.device_mesh import init_device_mesh

    from vbr_tpu_torch.parallel import mesh_sharded

    from vbr_tpu_torch.parallel.carve_sharded import (all_gather_dim,
                                                      local_block)

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("grid",))
    vol, kw = volume_scene(spec["volume"])
    tris, n = mesh_sharded.extract_mesh_sharded(vol, mesh, **kw)
    out = {"tris": tris, "n": np.asarray(n)}
    if vol.shape[0] % world == 0:
        act = mesh_sharded.sharded_active_cells(mesh)(
            local_block(vol, mesh, ("grid",), torch.device("cpu")))
        out["act"] = all_gather_dim(act, mesh, "grid")
    return out


def run_case(spec, world):
    kind = spec["kind"]
    if kind == "production":
        return run_production(spec)
    if kind == "runner":
        return run_runner(spec)
    if kind == "mesh":
        return run_mesh(spec, world)
    return run_tables(spec)


def main(workdir, rank, world):
    import torch.distributed as dist

    from vbr_tpu_torch.parallel import carve_sharded

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "cases.json")) as f:
        specs = [(cid, spec) for w, cid, spec in json.load(f) if w == world]
    carve_sharded.init_rank_group(os.path.join(workdir, f"store{world}"),
                                  rank, world, "cpu")
    results = {}
    try:
        for cid, spec in specs:
            for key, val in run_case(spec, world).items():
                if isinstance(val, torch.Tensor):
                    val = val.cpu().numpy()
                results[f"{cid}/{key}"] = np.asarray(val)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"w{world}_rank{rank}.npz"), **results)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

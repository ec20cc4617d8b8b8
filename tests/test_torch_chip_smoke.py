"""``chip_smoke.py``: refuses without a card or without the repository,
and its phases run end to end on the CPU at a small rig size (where every
"kernel" is its plain version, so this checks the script, not the card)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_refuses_without_a_card():
    res = _run(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_phases_run_on_cpu_small_rig(capsys, monkeypatch):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    # phase 24 has its own rehearsal (test_torch_chip_smoke_reports.py);
    # the hand-over check ahead of it still runs here
    monkeypatch.setattr(chip_smoke, "reports_phase",
                        lambda *a, **k: {"seconds": 0.0})
    from vbr_tpu_torch.utils.config import DEFAULT_MASK_PARAMS, GridConfig

    mp = [dataclasses.replace(p, figure_threshold=200.0, inner_threshold=8.0)
          for p in DEFAULT_MASK_PARAMS]
    report = chip_smoke.run("cpu", (120, 160), GridConfig(nx=32, ny=32,
                                                          nz=32),
                            focal=120.0, mask_params=mp, train_frames=3,
                            k3_frames=2, label_large_hw=(16, 256),
                            label_cap=16,
                            seam_sizes=((32, 16, 32), (20, 8, 16)),
                            roi_hw=(112, 128), large_edges=(64, 32),
                            calib_hw=(244, 322), calib_views=3,
                            calib_iters=30, ext_hw=(243, 322), ext_cams=2,
                            ext_iters=20, ext_bg_frames=8, ext_grid=32,
                            viewer_grid=32, viewer_hw=(72, 96),
                            viewer_points=20_000, cli_frames=(1, 2),
                            cli_grid=32, cli_nf=(2, 2, 1))
    names = [k["name"] for k in report["kernels"]]
    assert names == ["K1 carve_blocked", "K2 ccl_combined", "K3 mog_train",
                     "K4 carve_frames", "K5 ccl_label"]
    for k in report["kernels"]:
        assert k["max_abs_err"] == 0 and k["bound_ms"] > 0
        # the labelling kernels also report the route their launcher took,
        # the carves and the training kernel what they launch
        more = ({"kernel_route"} if k["name"][:2] in ("K2", "K5")
                else {"launch"})
        if k["name"][:2] in ("K1", "K2"):  # also counted on phase 21's path
            more |= {"launches_sharded"}
        more |= {"launches_cli"}  # counted on phase 23's CLI commands
        assert set(k) == {"name", "route", "source", "replaces", "launches",
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "profiler_ms"} | more
        assert k["profiler_ms"] is None  # no profile on the CPU
        assert os.path.exists(os.path.join(ROOT, k["source"]))
    out = capsys.readouterr().out
    assert "overflow bits set" in out and "FAILED" not in out
    for phase in ("[9] K3", "[10] train_background", "[11] K4",
                  "[12] process_frames_offline", "[13] K5"):
        assert phase in out
    assert "bit-equal to the plain version on the CPU" in out
    for name in ("K2", "K5"):
        assert f"{name}: the cap cut the corridor short at 16" in out
        assert f"{name}: iteration counts differ within the batch" in out
        assert f"{name}: the cap cut the upright corridor short too" in out
        for what in ("checkerboard", "band seams", "too large for a cluster",
                     "small", "dense random image", "crossing column sweeps"):
            assert f"{name} {what}" in out
    for what in ("all masks empty", "all masks full", "views_threshold 3 of 4",
                 "random masks, threshold 2", "32^3 grid, colour camera 2",
                 "32^3 grid, 3 cameras"):
        assert f"ok: K1 {what}: occupancy and colours bit-equal" in out
    for what in ("all masks empty", "all masks full",
                 "random masks, threshold 2", "views_threshold 3 of 4",
                 "full in one frame only", "NF = 1", "NF = 5", "NF = 9",
                 "NF = 16", "32^3 grid", "32^3 grid, 3 cameras"):
        assert f"ok: K4 {what}: occupancy bit-equal" in out
    for n in (1, 5, 9, 16):
        assert f"K4: a chunk of {n} frames sets the voxels of its" in out
    for what in ("random frames on the mid-training state", "K = 3, 37x53",
                 "K = 1, 37x53", "37x53, a single frame",
                 "37x53, chunk 2 of two in a row",
                 "37x53, the state handed over without its mark"):
        assert f"ok: K3 {what}" in out
    assert "K3: random frames drive a pixel to" in out
    assert report["clock"] == {"launch_floor_ms": None,
                               "k1_ms_zeroing_flush": None}
    assert "equal to process_frame_fast" in out
    assert report["offline"]["frames"] == 16
    # phase 14: the seam on the rig, both grids, the routes, the cache
    seam = report["seam"]
    assert seam["size"] == [32, 16, 32] and seam["frames"] == 8
    assert min(seam["occupied_voxels"]) > 0
    assert set(seam["split_ms"]) == {"step", "compact", "tolist"}
    for what in ("set_voxel_positions(32, 16, 32) on cpu: 8 frames, then "
                 "([], [])", "positions and colours lists equal",
                 "get_cam_positions and get_cam_rotation_matrices equal",
                 "set_voxel_positions(20, 8, 16) takes the table step",
                 "masks(ccl_backend=device, host, device-xla) equal",
                 "VisualHull(cache_dir=): the first model built"):
        assert f"ok: {what}" in out
    # phase 15: every camera count past the ring
    for C in (55, 56, 64, 300):
        assert f"ok: K1 with {C} cameras: occupancy and colours" in out
    for C in (55, 56, 57, 64, 255, 300):
        assert f"ok: K4 with {C} cameras, 8 frames: occupancy" in out
    # phase 16: the surface path on both inputs, both transfers, the rest
    surface = report["surface"]
    assert surface["capacity"] == 32768
    assert set(surface["held"]) == {"synthetic", "rig 0", "rig 4"}
    assert all(h["n_active"] > 0 and not h["redo"]
               for h in surface["held"].values())
    assert set(surface["stream_surface"]) == {
        "stream full", "stream wire", "rig full", "rig wire"}
    for what in ("process_frame_surface('cubes', 'join') on the synthetic "
                 "frame: triangles, occupancy and colours bit-equal",
                 "process_frame_surface('cubes', 'join') on rig frame 4",
                 "process_frame_surface('tetrahedra', 'separate') on rig "
                 "frame 0", "process_frame_surface('cubes', 'separate') on "
                 "rig frame 0",
                 "stream_surface(transfer='full') on the stream's 16 frames",
                 "stream_surface(transfer='wire') on the stream's 16 frames",
                 "stream_surface(transfer='full') on the rig's 8 frames",
                 "stream_surface(transfer='wire') on the rig's 8 frames",
                 "the wire's host tail gives rig frame 0's triangles",
                 "extract_mesh on the step's occupancy gives the same "
                 "triangles, occupancy and colours",
                 "surface_program(block_capacity=2) on three separated cubes",
                 "extract_surface equals process_frame_surface",
                 "textured_frame: occupancy, colours and cam_choice equal"):
        assert f"ok: {what}" in out
    # phase 17: the viewer stream, the guard, the wire, the native tails
    viewer = report["viewer"]
    assert viewer["wire_bytes"] == 12 + 512 * (4 + 64) + 98304 * 3
    assert set(viewer["stream_viewer"]) == {"bgr", "yuv420", "yuv420_roi"}
    assert viewer["roi_modes"][0] == "yuv420"
    assert set(viewer["redone"]) == set(viewer["raw_components"]) == {
        "bgr", "yuv420", "yuv420_roi"}
    assert "yuv420_roi" in viewer["roi_modes"][1:]
    assert set(viewer["stream_surface"]) == {
        "yuv420 full", "yuv420 wire", "yuv420_roi full", "yuv420_roi wire"}
    assert set(viewer["host_ms"]) == {
        "yuv420_pack", "yuv420_pack_numpy", "tracker_update",
        "roi_crop_and_pack", "mc_emit", "mc_emit_numpy"}
    for what in ("stream_viewer(ingest='bgr') on the rig's 8 frames: "
                 "(positions, rgb) bit-equal",
                 "stream_viewer(ingest='yuv420') on the rig's 8 frames",
                 "stream_viewer(ingest='yuv420_roi') on the rig's 8 frames",
                 "stream_viewer(ingest='bgr') equals compact_voxels_blocked",
                 "validate_reduced_ingest(ingest='yuv420') on rig frame 2 "
                 "equal", "validate_reduced_ingest(ingest='yuv420_roi')",
                 "rig frame 1's wire from a 'bgr' upload (329740 B",
                 "rig frame 1's wire from a 'yuv420' upload",
                 "rig frame 1's wire from a 'yuv420_roi' upload",
                 "a wire of", "the wire's parts on rig frame 0",
                 "phase 7's overflow frame sets the wire's overflow word",
                 "stream_surface(ingest='yuv420', transfer='full')",
                 "stream_surface(ingest='yuv420', transfer='wire')",
                 "stream_surface(ingest='yuv420_roi', transfer='full')",
                 "stream_surface(ingest='yuv420_roi', transfer='wire')",
                 "native.yuv420_pack byte-equal to the numpy pack",
                 "native.mc_emit bit-equal to the numpy tail"):
        assert f"ok: {what}" in out
    # phase 18: large grids, here at 64^3 for the rig and 32^3 x 8 cameras
    large = report["large_grid"]
    assert set(large["builds"]) == {"synthetic rig", "rig"}
    assert all(sum(b["suspicious"]) > 0 for b in large["builds"].values())
    assert large["rig"]["grid"] == [64, 64, 64]
    assert large["rig"]["build"] == "host"  # the device build from 256^3
    assert set(large["rig"]["surface"]) == {"rig 0", "rig 4"}
    assert large["stretch"]["grid"] == [32, 32, 32]
    assert large["stretch"]["cameras"] == 8
    assert large["stretch"]["fused_differ"] <= 3
    for what in ("synthetic rig at (32, 32, 32): build_block_tables("
                 "accelerate=True) on cpu equal to the f64 host tables of "
                 "phase 3", "rig at (32, 32, 32): build_block_tables("
                 "accelerate=True) on cpu equal to the f64 host tables of "
                 "phase 14", "the rig at (64, 64, 64): the model's host build",
                 "process_frame_fast at (64, 64, 64) over 8 rig frames: "
                 "occupancy and colours equal",
                 "K1 at (64, 64, 64) bit-equal to its plain version",
                 "process_frames_offline at (64, 64, 64) over 8 frames",
                 "process_frame_surface('cubes', 'join') at (64, 64, 64) on "
                 "rig frame 0", "process_frame_surface('cubes', 'join') at "
                 "(64, 64, 64) on rig frame 4",
                 "build_block_tables(accelerate=None) at (32, 32, 32) x 8 "
                 "cameras took the host build",
                 "carve_blocked at (32, 32, 32) x 8 cameras: occupancy and "
                 "colours of occupied voxels equal to carve_from_tables",
                 "Reconstructor(use_tables=False) at (32, 32, 32):",
                 "Reconstructor(use_tables=False) at (32, 32, 32) on the "
                 "rig: occupancy and colours equal on cpu and on the CPU"):
        assert f"ok: {what}" in out
    # phase 19: calibration on boards rendered at the real poses, here 3
    # per camera at 244x322 and 30 Adam steps
    calib = report["calibration"]
    assert calib["image_hw"] == [244, 322] and calib["iters"] == 30
    assert set(calib["cameras"]) == {1, 2, 3, 4}
    for cam, c in calib["cameras"].items():
        assert c["views"] == 3 and "noisy" in c["lm"]
        assert c["lm"]["noisy"]["rtol"] == 0  # the CPU against itself
        assert c["photometric"]["views"] >= 3
        for what in (f"cam{cam}: detect_chessboard finds the board in the "
                     "same", f"cam{cam}: corners on cpu and the CPU within",
                     f"cam{cam}: calibrate_camera on the 3 noisy views, cpu "
                     "vs CPU"):
            assert f"ok: {what}" in out
    assert calib["adam"]["route"] == "eager"
    assert calib["adam"]["eager_ms_per_step"] > 0
    for what in ("discard_bad_image_points on cam1's first 3 views: the same",
                 "save_camera_config then load_camera_config gives cam1's",
                 "cam1 at the warm start: loss on cpu and the CPU within",
                 "cam1: the first 30 Adam steps' losses on cpu and the CPU",
                 "cam1 with fix_pp, 30 steps: cx and cy pinned within 0.0e+00"):
        assert f"ok: {what}" in out
    assert "photometric fx and fy within 1 %" not in out  # production only
    # phase 20: extrinsics on two cameras at 243x322, 20 photometric steps,
    # MOG2 and KNN on phase 10's three frames
    ext = report["extrinsics"]
    assert ext["image_hw"] == [243, 322] and ext["cameras"] == 2
    assert ext["iters"] == 20 and ext["flips"] == [False, False]
    assert min(ext["n_blobs"]) >= 20 and min(ext["n_matched"]) >= 20
    assert len(ext["votes"]) == 2 and len(ext["carve_ab"]) == 2
    assert ext["refine_card_vs_cpu"] == {"rad": 0.0, "mm": 0.0,
                                         "loss_rtol": 0.0}
    assert len(ext["mog2_ms_per_frame"]) == len(ext["knn_ms_per_frame"]) == 4
    for what in ("cam1: the board sheet on cpu and on the CPU equal",
                 "cam1: detect_black_squares on the two sheets: the same",
                 "cam1: photometric_refine on cpu and the CPU within 0.0e+00",
                 "quick_person_masks and resolve_rig_orientation on cpu and "
                 "on the CPU: masks, votes and flips equal",
                 "evaluate_pose_sets(recovered, committed) on cpu and the CPU",
                 "hull_coverage at 32^3 under the committed poses on cpu",
                 "carve_silhouette_ab, camera 1 flipped: reports equal",
                 "carve_silhouette_ab, camera 2 flipped: reports equal",
                 "train_mog2 over 3 frames: camera 1's rows",
                 "extract_mask_mog2 on camera 1's rows: masks bit-equal",
                 "train_knn over the first 3 frames (the round-robin fill)",
                 "apply_knn on the card's state after 3 frames carried",
                 "raw_masks_batched over 4 cameras on cpu and on the CPU",
                 "BackgroundPipeline from frames: masks_for_frames equal",
                 "BackgroundPipeline from npz: masks_for_frames equal"):
        assert f"ok: {what}" in out
    assert "every recovered pose within" not in out  # production only
    # phase 21: the sharded step on a one-rank gloo group, 2/4/8 shards
    # emulated at the rig's 32^3 and the 8-camera 32^3 tables of phase 18
    sharded = report["sharded"]
    assert sharded["runner"]["backend"] == "gloo"
    assert set(sharded["runner"]["ms"]) == {"contiguous", "strided", "cost"}
    assert [e["cameras"] for e in sharded["emulated"]] == [4, 8]
    for e in sharded["emulated"]:
        assert set(e["shards"]) == {f"{S}/{m}" for S in (2, 4, 8) for m in (
            "contiguous", "strided", "cost")}
    assert sharded["k2_images_per_launch"] == [4, 2, 1]
    for mode in ("contiguous", "strided", "cost"):
        assert (f"ok: ShardedRunner(order={mode!r}) on 8 rig frames equal "
                "to process_frame_fast(layout='blocked') bit for bit") in out
    for what in ("sharded step overflow bits", "extract_mesh_sharded equals "
                 "extract_mesh", "sharded_carve_step equals carve_from_tables",
                 "sharded_pipeline_step(clean=False) equals the one-device",
                 "sharded_pipeline_step(clean=True) equals the one-device",
                 "the rig at (32, 32, 32): the union of 8 shards (cost) "
                 "equals the unsharded K1",
                 "8 cameras at (32, 32, 32): the union of 8 shards (cost)",
                 "K2 on 1 image(s) (cam = 4, shard 3) equals its plain"):
        assert f"ok: {what}" in out
    # phase 22: the viewer's headless render, here at 32^3, 96x72 and
    # 20,000 lattice points
    assert "[22] the viewer's headless render" in out
    vr = report["viewer_render"]
    assert vr["image_hw"] == [72, 96] and vr["grid"] == [32, 32, 32]
    assert vr["frames"] == 8 and min(vr["voxels"]) > 0
    assert min(vr["covered_pixels"]) > 0
    assert vr["points"] == 20_000 and vr["tied_depths"] > 0
    assert set(vr["ms"]) == {"render_rig_hull", "render_capacity", "frame",
                             "masks", "carve", "compact",
                             "cpu_render_rig_hull", "cpu_render_capacity"}
    assert set(vr["gl_packages"]) == {"OpenGL.GL", "glfw", "PIL.Image"}
    for what in ("the viewer's recarve on the rig at 32^3 over 8 frames, "
                 "then None, rendered at 96x72 with the floor and the "
                 "cameras along the orbit",
                 "save_png of frame 0",
                 "20000 seeded points of the 32^3 lattice"):
        assert f"ok: {what}" in out
    assert "the render's share" in out
    # phase 23: the CLI on MJPEG videos at the rig's size, here 1
    # background and 2 video frames per camera at --grid 32
    assert "[23] the CLI on a rig directory of MJPEG videos" in out
    cr = report["cli"]
    assert (cr["frames"], cr["background_frames"], cr["grid"]) == (2, 1, 32)
    assert cr["card"] == "cpu" and cr["stream"]["frames"] == 2
    assert set(cr["launches"]) == {
        "pipeline", "pipeline --offline", "masks", "carve",
        "carve --batched", "mesh", "render"}
    assert set(cr["launches_cli"]) == {"carve_blocked", "ccl_combined",
                                       "mog_train", "carve_frames",
                                       "ccl_label"}
    assert cr["decode_ms_per_frame"] > 0 and cr["prefetch_ms_per_frame"] > 0
    assert cr["train_s"] > 0 and cr["cli_offline_ms"] > 0
    assert len(cr["extrinsics"]["pose_errors"]) == 2
    for what in ("cam1/video.avi: the container's count 2 frames of 644x486",
                 "cam4/background.avi: the container's count 1 frames",
                 "cam1/video.avi decodes to 2 frames, the container's count",
                 "read_video, frame_iterator, get_frame (frames [0, 1], "
                 "None past the end) and PrefetchingSource give the same",
                 "pipeline's from_data_dir: 4 x 1 background frames decoded "
                 "and trained", "pipeline streamed every frame: '2 frames: ",
                 "masks' cache of camera 1 equals the model pipeline trained",
                 "the stream's occupancy equals `--offline 2`'s on every one "
                 "of the 2 frames (2 stream and 2 offline frames; differ: [])",
                 "every frame occupies voxels (",
                 "stream.ply: ", "hull.ply: ",
                 "calibrate --mode extrinsics on MJPEG video: every pose "
                 "within 0.01 rad and 25.0 mm"):
        assert f"ok: {what}" in out
    # on the CPU the commands' CPU side would compare the CPU with itself
    assert "  the CPU side is skipped: the commands above ran on the CPU" in out
    assert cr["cpu_seconds"] == {} and cr["stream"]["period_mean_ms"] > 0
    for line in ("    | wrote ", "    | marching tetrahedra: ",
                 "    | batched carve: 2 frames in ",
                 "    | 2 frames offline (2/launch): ",
                 "    | orientation vote: {"):
        assert line in out


def test_crossing_sweeps_meet_inside_every_band():
    """The image that holds the cluster route's two column sweeps apart:
    after one iteration the block holds its own label and every spine its
    own, lower from band to band; the second iteration carries each
    band's label down into the next while the last band's goes up."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from vbr_tpu_torch.ops import ccl_label

    H, W, bands = 488, 768, 8
    R = H // bands
    img = torch.from_numpy(chip_smoke.crossing_sweeps(H, W, bands)[None])
    assert not bool(img[0, :, :32].any())  # no carry in a warp's first columns
    for plain in (ccl_label.label_components_batched_plain,
                  ccl_label.label_components_combined_plain):
        one = plain(img, max_iters=1)[0][0]
        two = plain(img, max_iters=2)[0][0]
        spines = [int(one[(b + 1) * R - 1, 160 + 4 * b]) for b in range(bands)]
        assert spines == sorted(spines, reverse=True) and len(set(spines)) == 8
        block = one[2 * bands + 4:, 32:128]
        assert int(block.min()) == int(block.max()) > spines[0]
        assert bool((two[2 * bands + 4:, 32:128] == spines[-1]).all())


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_timed_ms_on_the_cpu_is_the_host_clock_around_fn():
    """On the CPU the clock keeps its meaning: one warm-up call, then
    ``reps`` calls of ``fn(setup())`` with the flush before each and only
    ``fn`` inside the interval; the median comes back in ms."""
    import time

    chip_smoke = _chip_smoke()
    calls = []

    def setup():
        calls.append("setup")
        time.sleep(0.02)  # not timed
        return 7

    def fn(x):
        assert x == 7
        calls.append("fn")
        time.sleep(0.002)

    ms = chip_smoke.timed_ms(fn, torch, torch.device("cpu"), reps=3,
                             flush=lambda: calls.append("flush"), setup=setup)
    assert calls == ["setup", "fn"] + ["setup", "flush", "fn"] * 3
    assert 2.0 <= ms < 15.0
    assert chip_smoke.timed_ms(lambda: None, torch, torch.device("cpu"),
                               reps=2) < 1.0


def test_random_chunk_drives_pixels_past_the_cached_slots():
    """What the card check of K3's second residence depends on: on the
    mid-training state, 16 frames of random colours leave some pixel with
    more slots in use than the kernel keeps in shared memory."""
    import numpy as np

    chip_smoke = _chip_smoke()
    from vbr_tpu_torch.ops import gmm
    from vbr_tpu_torch.utils.config import MOGParams

    rng = np.random.default_rng(3)
    H, W = 12, 20
    bg_hsv = rng.integers(60, 200, (H, W, 3)).astype(np.uint8)
    p = MOGParams()
    ts0 = chip_smoke.train_state_from_mog(
        chip_smoke.mog_state(rng, bg_hsv, torch), torch, p.history - 8)
    assert int(gmm.slot_high_water(ts0.weight, ts0.sort_key).max()) == 3
    frames = torch.from_numpy(chip_smoke.random_chunk(
        rng, chip_smoke.TRAIN_CHUNK, H, W))
    end = gmm.train_chunk_plain(ts0, frames, p)
    mark = gmm.slot_high_water(end.weight, end.sort_key)
    assert int(mark.max()) > gmm.K3_CACHE_SLOTS >= 7
    assert int(mark.min()) >= 3


@pytest.mark.parametrize("cam", [1, 2, 3, 4])
def test_png_reader_matches_pil_on_the_rig_masks(cam):
    """The card's host has no image library: the script reads the rig's
    silhouettes with its own reader, which must give PIL's pixels."""
    import numpy as np
    from PIL import Image

    chip_smoke = _chip_smoke()
    path = os.path.join(ROOT, chip_smoke.RIG_MASKS.format(cam))
    got = chip_smoke.read_png_gray(path)
    want = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and got.shape == chip_smoke.RIG_HW
    np.testing.assert_array_equal(got, want)


def _png_rows(img, row_filter, bpp):
    """The PNG standard's filter ``row_filter`` applied to every row of an
    (H, W·bpp) int64 image, each byte predicted from the one ``bpp`` to
    its left: the scanlines with their filter bytes."""
    n = img.shape[1]
    rows, up = [], np.zeros(n, np.int64)
    for line in img:
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if row_filter == 4:
            p = left + up - up_left
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        else:
            pred = [0 * line, left, up, (left + up) // 2][row_filter]
        rows.append(bytes([row_filter]) + bytes(((line - pred) % 256)
                                                .astype(np.uint8)))
        up = line
    return b"".join(rows)


def _png_file(path, W, H, colour, rows):
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows))
                     + chunk(b"IEND", b""))


@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4])
def test_png_reader_undoes_each_row_filter_rgb(tmp_path, row_filter):
    """An RGB PNG whose rows all carry one filter type (a byte's left is
    the same channel of the pixel before) reads back as PIL reads it."""
    from PIL import Image

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(10 + row_filter)
    img = rng.integers(0, 256, (7, 11, 3)).astype(np.int64)
    img[3:] = (img[3:] // 64) * 64
    path = tmp_path / "rgb.png"
    _png_file(path, 11, 7, 2, _png_rows(img.reshape(7, 33), row_filter, 3))
    got = chip_smoke.read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == (7, 11, 3)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError, match="grayscale"):
        chip_smoke.read_png_gray(str(path))


def test_png_reader_reads_the_viewers_png(tmp_path):
    """``headless.save_png``'s file reads back equal through the script's
    reader and through PIL."""
    from PIL import Image

    from vbr_tpu_torch.viewer import headless

    chip_smoke = _chip_smoke()
    img = np.random.default_rng(1).integers(0, 256, (30, 41, 3), np.uint8)
    path = str(tmp_path / "v.png")
    headless.save_png(path, torch.from_numpy(img))
    np.testing.assert_array_equal(chip_smoke.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4])
def test_png_reader_undoes_each_row_filter(tmp_path, row_filter):
    """A PNG whose rows all carry one filter type, encoded here by the PNG
    standard's definitions, reads back as PIL reads it."""
    import struct
    import zlib

    import numpy as np
    from PIL import Image

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(row_filter)
    img = rng.integers(0, 256, (9, 13)).astype(np.int64)
    img[4:] = (img[4:] // 64) * 64  # runs, so that predictions matter
    rows, up = [], np.zeros(13, np.int64)
    for line in img:
        left = np.concatenate([[0], line[:-1]])
        up_left = np.concatenate([[0], up[:-1]])
        if row_filter == 4:
            p = left + up - up_left
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        else:
            pred = [0 * line, left, up, (left + up) // 2][row_filter]
        rows.append(bytes([row_filter]) + bytes(((line - pred) % 256)
                                                .astype(np.uint8)))
        up = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path = tmp_path / "f.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", 13, 9, 8, 0,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))
    got = chip_smoke.read_png_gray(str(path))
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, img)

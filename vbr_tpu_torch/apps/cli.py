"""Command-line entry points of the port.

Counterpart of ``vbr_tpu/apps/cli.py``, with the same commands, arguments,
defaults, printed lines and output files:

    python -m vbr_tpu_torch.apps.cli calibrate --data DIR [--cams 1,2,3,4]
    python -m vbr_tpu_torch.apps.cli masks     --data DIR [--frame 0]
    python -m vbr_tpu_torch.apps.cli carve     --data DIR [--frames N] [--ply OUT]
    python -m vbr_tpu_torch.apps.cli mesh      --data DIR [--obj OUT]
    python -m vbr_tpu_torch.apps.cli render    --data DIR [--png OUT]
    python -m vbr_tpu_torch.apps.cli pipeline  --data DIR [--offline N]
    python -m vbr_tpu_torch.apps.cli view      --data DIR      (OpenGL window)

Every command runs on the card unless ``--cpu`` is given.  Videos are read
by ``utils/video.py`` (MJPEG or uncompressed AVI) and the annotated
calibration videos and ``render --animate``'s orbit are written as MJPEG
AVI files (``.avi`` where ``vbr_tpu`` writes ``.mp4``).  ``calibrate``
draws its plot of the intrinsics (``intrinsic_params_cam{c}.png``) with
``pipelines/reports.py``, without matplotlib.  ``--preview`` has no window
to show: it warns once (``utils/preview.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _add_common(p):
    p.add_argument("--data", default=os.environ.get(
        "VBR_DATA_DIR", os.path.join(_ROOT, "data")))
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain versions of the kernels)")
    p.add_argument("--out-dir", default="artifacts")
    p.add_argument(
        "--preview", type=int, default=0, metavar="MS",
        help="show intermediate results in a window for MS milliseconds "
        "(the reference's result_time_visible contract; <=0 disables; the "
        "port has no window toolkit, so it warns once)",
    )


def _device(args) -> str:
    return "cpu" if args.cpu else "cuda"


def _camera_params(K, dist):
    from vbr_tpu_torch.utils.config import CameraParams

    d = np.asarray(dist, np.float64).reshape(-1)
    return CameraParams(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), k1=float(d[0]), k2=float(d[1]), p1=float(d[2]),
        p2=float(d[3]), k3=float(d[4]) if d.size > 4 else 0.0)


def _gray(frame) -> np.ndarray:
    import torch

    from vbr_tpu_torch.ops.color import bgr_to_gray_u8

    return bgr_to_gray_u8(torch.from_numpy(np.ascontiguousarray(frame))) \
        .numpy()


def cmd_calibrate(args):
    from vbr_tpu_torch.ops import corners as corner_ops
    from vbr_tpu_torch.pipelines import calibration, validation
    from vbr_tpu_torch.utils import preview as preview_ui
    from vbr_tpu_torch.utils import video as vio
    from vbr_tpu_torch.utils import xmlio

    dev = _device(args)
    (bw, bh), square = xmlio.load_chessboard_info(
        os.path.join(args.data, "checkerboard.xml"))
    board = (bw, bh)
    cams = [int(c) for c in args.cams.split(",")]

    if args.mode == "extrinsics":
        # full-auto rig extrinsics: blob-lattice homography + photometric
        # board alignment + cross-camera 180° hull voting; `--no-auto`:
        # per-camera saddle detection
        if args.auto:
            from vbr_tpu_torch.ops import camera as cam_ops
            from vbr_tpu_torch.pipelines import auto_extrinsics as auto_ext

            rig = []
            for cam in cams:
                K, dist, _, _ = xmlio.load_camera_config(
                    os.path.join(args.data, f"cam{cam}"))
                rig.append(_camera_params(K, dist))
            res = auto_ext.auto_extrinsics(
                args.data, rig, square_mm=square, pattern=board,
                cam_indices=cams, device=dev)
            obj = calibration.chessboard_object_points(board, square)
            for cam, cp, mse, fl in zip(cams, res.cameras,
                                        res.photometric_mse, res.flips):
                K, dist = cp.K, cp.dist
                rvec, tvec = cp.rvec, cp.tvec
                out = os.path.join(args.out_dir, f"cam{cam}")
                xmlio.save_camera_config(out, K, dist, rvec, tvec)
                print(f"cam{cam}: auto pose (photometric MSE {mse:.0f}, "
                      f"180° flip={fl}), wrote {out}/config.xml")
                if args.annotate:
                    frame = vio.get_frame(
                        os.path.join(args.data, f"cam{cam}", args.video), 0)
                    pts = cam_ops.project_points(obj, rvec, tvec, K, dist)
                    overlay = frame.copy()
                    validation.draw_chessboard_corners(overlay, pts, board)
                    vio.write_jpeg(os.path.join(
                        out, "checkerboard_imagepoints.jpg"), overlay)
                    preview_ui.show_result(f"cam{cam} extrinsics", overlay,
                                           args.preview)
            print(f"orientation vote: {res.votes}")
            return
        poses = {}
        for cam in cams:
            cam_dir = os.path.join(args.data, f"cam{cam}")
            K, dist, _, _ = xmlio.load_camera_config(cam_dir)
            pose = None
            fi = 0
            with vio._capture(os.path.join(cam_dir, args.video)) as cap:
                while fi < max(args.stop_frame, 60):
                    ok, frame = cap.read()
                    if not ok:
                        break
                    pts = corner_ops.detect_chessboard(_gray(frame), board,
                                                       device=dev)
                    if pts is not None:
                        obj = calibration.chessboard_object_points(board,
                                                                   square)
                        rvec, tvec, inliers = calibration.solve_pnp_ransac(
                            obj, pts, K, dist, device=dev)
                        err = validation.reprojection_error(
                            obj[inliers], pts[inliers], K, dist, rvec, tvec)
                        pose = (rvec, tvec, err, fi)
                        if args.annotate:
                            # checkerboard_imagepoints.jpg, the reference's
                            # audit still (camera_calibration.py:482-484)
                            overlay = frame.copy()
                            validation.draw_chessboard_corners(overlay, pts,
                                                               board)
                            vio.write_jpeg(os.path.join(
                                args.out_dir, f"cam{cam}",
                                "checkerboard_imagepoints.jpg"), overlay)
                        break
                    fi += 1
            if pose is None:
                print(f"cam{cam}: no frame with detected corners — use the "
                      "manual corner session (apps/manual_corners.py)")
                continue
            poses[cam] = (K, dist) + pose

        # the saddle detector fixes the board frame only up to the board's
        # 180° symmetry: with the full rig detected, the hull vote resolves
        # it as the auto path does
        if len(poses) == len(cams) and len(cams) >= 2:
            from vbr_tpu_torch.pipelines import auto_extrinsics as auto_ext

            cam_params, cand = [], []
            for cam in cams:
                K, dist, rvec, tvec, err, fi = poses[cam]
                cam_params.append(_camera_params(K, dist))
                cand.append((np.asarray(rvec).ravel(),
                             np.asarray(tvec).ravel()))
            try:
                # needs per-camera background.avi + video.avi; missing
                # footage skips the vote, anything else propagates
                sil = auto_ext.quick_person_masks(
                    args.data, len(cams), cam_indices=cams, device=dev)
            except FileNotFoundError as e:
                print(f"orientation vote skipped ({e}); an "
                      f"{board[0]}x{board[1]} board has a 180° rotational "
                      "symmetry — align orientations across cameras "
                      "manually (or provide background.avi/video.avi per "
                      "camera for hull voting)")
                sil = None
            flips, votes = (None, None) if sil is None else \
                auto_ext.resolve_rig_orientation(
                    cam_params, cand, sil, square_mm=square, pattern=board,
                    device=dev)
            if flips is not None:
                ranked = sorted(votes.values(), reverse=True)
                margin = ranked[0] - (ranked[1] if len(ranked) > 1 else 0)
                print(f"orientation vote: best {ranked[0]} hull voxels, "
                      f"margin {margin} over runner-up; flips={flips}")
                for cam, fl in zip(cams, flips):
                    if fl:
                        K, dist, rvec, tvec, err, fi = poses[cam]
                        rv, tv = auto_ext.flip_pose_180(rvec, tvec, square,
                                                        board)
                        poses[cam] = (K, dist, rv, tv, err, fi)
        elif poses:
            print(f"note — an {board[0]}x{board[1]} board has a 180° "
                  "rotational symmetry; with only a partial rig detected "
                  "the hull vote is skipped, so align orientations across "
                  "cameras manually (or use the default auto mode)")

        for cam in cams:
            if cam not in poses:
                continue
            K, dist, rvec, tvec, err, fi = poses[cam]
            out = os.path.join(args.out_dir, f"cam{cam}")
            xmlio.save_camera_config(out, K, dist, rvec, tvec)
            print(f"cam{cam}: pose from frame {fi}, reproj {err:.2f}px, "
                  f"wrote {out}/config.xml")
        return

    if args.method == "photometric":
        from vbr_tpu_torch.pipelines import photometric_calibration as photo

        for cam in cams:
            video = os.path.join(args.data, f"cam{cam}", args.video)
            res, views = photo.calibrate_video_photometric(
                video, pattern=board, square_mm=square,
                frame_step=args.frame_interval
                if args.video == "checkerboard.avi" else 1,
                iters=args.photometric_iters, device=dev)
            print(f"cam{cam}: {len(views)} views, photometric MSE "
                  f"median {float(np.median(res.mse)):.0f}")
            print(f"cam{cam}: fx={res.K[0,0]:.2f} fy={res.K[1,1]:.2f} "
                  f"cx={res.K[0,2]:.2f} cy={res.K[1,2]:.2f} "
                  f"dist={np.round(res.dist, 4)}")
            out = os.path.join(args.out_dir, f"cam{cam}")
            xmlio.save_camera_config(
                out, res.K, res.dist, res.rvecs[0], res.tvecs[0],
                filename="config.xml")
            np.savez(os.path.join(out, "photometric_calib.npz"),
                     K=res.K, dist=res.dist, rvecs=res.rvecs,
                     tvecs=res.tvecs, mse=res.mse,
                     frame_indices=res.frame_indices,
                     loss_curve=res.loss_curve)
            print(f"cam{cam}: wrote {out}/config.xml")
        return

    from vbr_tpu_torch.native import VideoSink

    for cam in cams:
        video = os.path.join(args.data, f"cam{cam}", args.video)
        image_points = []
        frame_idx = 0
        w = h = None
        sink = None
        with vio._capture(video) as cap:
            while True:
                ok, frame = cap.read()
                if not ok or (args.stop_frame
                              and frame_idx >= args.stop_frame):
                    break
                if frame_idx % args.frame_interval == 0:
                    gray = _gray(frame)
                    h, w = gray.shape
                    pts = corner_ops.detect_chessboard(gray, board,
                                                       device=dev)
                    if pts is not None:
                        image_points.append(pts.astype(np.float32))
                    if args.annotate:
                        # the annotated detection video at 1 fps, the
                        # reference's intrinsics_imagepoints audit artifact
                        if sink is None:
                            out_avi = os.path.join(
                                args.out_dir, f"cam{cam}",
                                f"{os.path.splitext(args.video)[0]}"
                                "_imagepoints.avi")
                            sink = VideoSink(out_avi, 1.0, w, h)
                        overlay = frame.copy()
                        if pts is not None:
                            validation.draw_chessboard_corners(overlay, pts,
                                                               board)
                        sink.write(overlay)
                        preview_ui.show_result(f"cam{cam} corners", overlay,
                                               args.preview)
                frame_idx += 1
        if sink is not None:
            sink.close()
        print(f"cam{cam}: {len(image_points)} views with detected corners")
        if len(image_points) < 3:
            print(f"cam{cam}: not enough views; skipping")
            continue
        res = calibration.calibrate_camera(image_points, (w, h), board,
                                           square, device=dev)
        print(f"cam{cam}: rms={res.rms:.3f}px fx={res.K[0,0]:.2f} "
              f"fy={res.K[1,1]:.2f} cx={res.K[0,2]:.2f} cy={res.K[1,2]:.2f}")
        runs = [dict(label="all views", rms=res.rms,
                     per_view_errors=res.per_view_errors, K=res.K,
                     intrinsic_std=res.intrinsic_std)]
        if args.discard:
            kept, kept_idx, _, dropped = calibration.discard_bad_image_points(
                image_points, (w, h), board, square,
                discard_threshold=args.discard_threshold, device=dev)
            if dropped:
                print(f"cam{cam}: discarded views {dropped}")
                res = calibration.calibrate_camera(kept, (w, h), board,
                                                   square, device=dev)
                runs.append(dict(label="after discard", rms=res.rms,
                                 per_view_errors=res.per_view_errors,
                                 K=res.K, intrinsic_std=res.intrinsic_std))
                print(f"cam{cam}: rms after discard {res.rms:.3f}px")
        from vbr_tpu_torch.pipelines import reports

        reports.plot_intrinsic_results(
            runs, os.path.join(args.out_dir, f"intrinsic_params_cam{cam}.png"))
        out = os.path.join(args.out_dir, f"cam{cam}")
        xmlio.save_camera_config(
            out, res.K, res.dist, res.rvecs[0], res.tvecs[0],
            filename="config.xml")
        print(f"cam{cam}: wrote {out}/config.xml")


def cmd_masks(args):
    from vbr_tpu_torch.pipelines import background
    from vbr_tpu_torch.utils import preview as preview_ui
    from vbr_tpu_torch.utils import video as vio
    from vbr_tpu_torch.viewer import headless

    pipe = background.BackgroundPipeline(
        args.data, cache_dir=os.path.join(args.out_dir, "bg_cache"),
        device=_device(args))
    src = vio.MultiCameraSource(args.data)
    frames = None
    for _ in range(args.frame + 1):
        frames = src.next_frames()
    src.release()
    masks = pipe.masks_for_frames(frames)
    os.makedirs(args.out_dir, exist_ok=True)
    for c in range(masks.shape[0]):
        path = os.path.join(args.out_dir, f"mask_cam{c+1}.png")
        headless.save_png(path, masks[c])
        print(f"wrote {path} (fg {np.mean(masks[c] > 0):.4f})")
        preview_ui.show_result(f"mask cam{c+1}", masks[c], args.preview)
    preview_ui.close_all()


def _carve_setup(args):
    from vbr_tpu_torch.pipelines import background, reconstruction
    from vbr_tpu_torch.utils.config import GridConfig, RigConfig

    dev = _device(args)
    grid = GridConfig(nx=args.grid, ny=args.grid, nz=args.grid)
    cams = reconstruction.load_rig(args.data)
    recon = reconstruction.Reconstructor(cams, grid, RigConfig(), device=dev)
    pipe = background.BackgroundPipeline(
        args.data, cache_dir=os.path.join(args.out_dir, "bg_cache"),
        device=dev)
    return grid, cams, recon, pipe


def _viewer_positions(pts, idx, col, rig):
    """Viewer positions and RGB of occupied voxels ``idx`` (host colours
    ``col`` BGR u8), as ``carve.compact_voxels`` makes them."""
    kept = np.trunc(pts[idx])
    pos = np.stack([kept[:, 0], -kept[:, 2], kept[:, 1]], -1) \
        .astype(np.float32) / rig.scaling_factor
    return pos, col[:, ::-1].astype(np.float32) / 255.0


def cmd_carve(args):
    from vbr_tpu_torch.pipelines import reconstruction
    from vbr_tpu_torch.utils import video as vio

    grid, cams, recon, pipe = _carve_setup(args)
    src = vio.MultiCameraSource(args.data)

    if args.batched and args.frames > 1:
        # offline throughput path: the multi-frame carve (kernel K4, N
        # frames per launch) + host colour gather at occupied voxels
        import torch

        from vbr_tpu_torch.ops import carve_blocked
        from vbr_tpu_torch.utils.config import RigConfig

        rig = RigConfig()
        all_frames, all_masks = [], []
        for _ in range(args.frames):
            frames = src.next_frames()
            if frames is None:
                break
            all_frames.append(frames)
            all_masks.append(pipe.masks_for_frames(frames))
        src.release()
        F = len(all_masks)
        if F == 0:
            print("no frames available; nothing to carve")
            return
        btab = carve_blocked.build_block_tables(
            cams, grid, all_masks[0].shape[1:3],
            color_camera=rig.color_camera, device=recon.device)
        t0 = time.time()
        occ = carve_blocked.carve_frames_blocked(
            torch.from_numpy(np.stack(all_masks)).to(recon.device), btab,
            views_threshold=rig.views_threshold).cpu().numpy()
        dt = time.time() - t0
        print(f"batched carve: {F} frames in {dt:.2f}s "
              f"({dt / F * 1e3:.1f} ms/frame)")
        lin_idx = recon.tables.lin_idx.cpu().numpy()
        pts = grid.voxel_points()
        for i in range(F):
            idx, col = carve_blocked.frame_colors_host(
                occ[i], all_frames[i][rig.color_camera], lin_idx,
                color_camera=rig.color_camera)
            pos, rgb = _viewer_positions(pts, idx, col, rig)
            print(f"frame {i}: {len(pos)} voxels")
            if args.ply:
                reconstruction.write_ply(f"{args.ply}.{i}.ply", pos, rgb)
        return

    for i in range(args.frames):
        frames = src.next_frames()
        if frames is None:
            break
        t0 = time.time()
        masks = pipe.masks_for_frames(frames)
        pos, col = recon.carve_frame_compact(masks, frames)
        print(f"frame {i}: {len(pos)} voxels in {time.time()-t0:.2f}s")
        if args.ply:
            path = args.ply if args.frames == 1 else f"{args.ply}.{i}.ply"
            reconstruction.write_ply(path, pos, col)
            print(f"  wrote {path}")
    src.release()


def cmd_mesh(args):
    from vbr_tpu_torch.ops import marching_cubes as mc
    from vbr_tpu_torch.utils import video as vio

    grid, cams, recon, pipe = _carve_setup(args)
    src = vio.MultiCameraSource(args.data)
    frames = src.next_frames()
    src.release()
    masks = pipe.masks_for_frames(frames)
    volume = recon.occupancy_volume(masks, frames)
    xs, ys, zs = grid.axis_ranges()
    spacing = (xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0])
    tris, n = mc.extract_mesh(
        volume, origin=(xs[0], ys[0], zs[0]), spacing=spacing,
        algorithm=args.algorithm, ambiguity=args.ambiguity,
        device=recon.device)
    print(f"marching {args.algorithm}: {n} triangles")
    if args.obj:
        mc.write_obj(args.obj, tris)
        print(f"wrote {args.obj}")


def _floor_and_cameras(cams):
    from vbr_tpu_torch.pipelines import reconstruction

    floor_pos, floor_col = reconstruction.generate_grid(64, 64)
    cam_pos, cam_col = reconstruction.get_cam_positions(cams)
    return (np.asarray(floor_pos), np.asarray(floor_col),
            np.asarray(cam_pos, float), cam_col)


def cmd_render(args):
    if args.gl:
        # must precede any OpenGL import
        os.environ.setdefault("EGL_PLATFORM", "surfaceless")
        os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
        os.environ.setdefault("LIBGL_ALWAYS_SOFTWARE", "1")
    from vbr_tpu_torch.utils import video as vio
    from vbr_tpu_torch.viewer import headless

    grid, cams, recon, pipe = _carve_setup(args)
    if args.animate > 0:
        return _render_animation(args, cams, recon, pipe)
    src = vio.MultiCameraSource(args.data)
    frames = src.next_frames()
    src.release()
    masks = pipe.masks_for_frames(frames)
    pos, col = recon.carve_frame_compact(masks, frames)
    png = args.png or os.path.join(args.out_dir, "render.png")
    if args.gl:
        img = _render_gl_offscreen(pos, col, cams)
    else:
        img = headless.render_points(pos, col, device=recon.device)
        headless.render_floor_and_cameras(img, *_floor_and_cameras(cams))
    headless.save_png(png, img)
    print(f"wrote {png} ({len(pos)} voxels)")


def orbit_pose(theta_deg: float, radius: float = 38.0, height: float = 24.0,
               target=(4.0, 6.0, 0.0)):
    """Camera pose on a horizontal orbit, always looking at ``target``.

    Returns (eye, pitch, yaw) in the FlyCamera convention (front vector
    = (cos yaw·cos pitch, sin pitch, sin yaw·cos pitch))."""
    th = np.radians(theta_deg)
    eye = np.array([
        target[0] + radius * np.cos(th),
        height,
        target[2] + radius * np.sin(th),
    ])
    d = np.asarray(target, float) - eye
    dist = np.linalg.norm(d)
    pitch = float(np.degrees(np.arcsin(d[1] / dist)))
    yaw = float(np.degrees(np.arctan2(d[2], d[0])))
    return tuple(eye), pitch, yaw


def _render_animation(args, cams, recon, pipe):
    """`render --animate N`: N frames through the pipeline, each rendered
    from a camera on an orbit, encoded as an MJPEG AVI."""
    from vbr_tpu_torch.native import VideoSink
    from vbr_tpu_torch.utils import video as vio
    from vbr_tpu_torch.viewer import headless

    W, H = 1280, 720
    out = args.png or os.path.join(args.out_dir, "hull_anim.avi")
    if not out.endswith(".avi"):
        out = os.path.splitext(out)[0] + ".avi"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    target = (4.0, 6.0, 0.0)  # orbit_pose's look-at, shared by both paths
    renderer = None
    src = None
    n = 0
    try:
        renderer = GLSceneRenderer(cams, (W, H)) if args.gl else None
        src = vio.MultiCameraSource(args.data)
        furniture = _floor_and_cameras(cams) if renderer is None else None
        with VideoSink(out, fps=12.5, width=W, height=H) as sink:
            while n < args.animate:
                frames = src.next_frames()
                if frames is None:
                    break
                masks = pipe.masks_for_frames(frames)
                pos, col = recon.carve_frame_compact(masks, frames)
                eye, pitch, yaw = orbit_pose(-135.0 + 360.0 * n / args.animate)
                if renderer is not None:
                    img = renderer.render(pos, col, eye, pitch, yaw)
                else:
                    img = headless.render_points(
                        pos, col, eye=eye, target=target, image_hw=(H, W),
                        device=recon.device)
                    headless.render_floor_and_cameras(
                        img, *furniture, eye=eye, target=target)
                    img = img.cpu().numpy()
                sink.write(np.ascontiguousarray(img[..., ::-1]))  # RGB→BGR
                n += 1
    finally:
        if src is not None:
            src.release()
        if renderer is not None:
            renderer.close()
    print(f"wrote {out} ({n} frames, orbit render)")


class GLSceneRenderer:
    """Reusable offscreen scene renderer through the GL engine (EGL
    surfaceless): floor + camera markers persist, per-frame voxel
    instances re-upload, camera pose per frame.  Needs PyOpenGL."""

    def __init__(self, cams, wh=(1280, 720)):
        from OpenGL import GL as gl

        from vbr_tpu_torch.pipelines import reconstruction
        from vbr_tpu_torch.viewer import gl_engine as eng
        from vbr_tpu_torch.viewer.offscreen import OffscreenContext

        self.gl, self.eng = gl, eng
        self.W, self.H = wh
        self.ctx = OffscreenContext(self.W, self.H)
        self.ctx.__enter__()
        try:
            gl.glEnable(gl.GL_DEPTH_TEST)
            self.prog = eng.compile_program(eng.VERT_SRC, eng.FRAG_SRC)
            self.cubes = eng.InstancedCubes()
            self.floor = eng.InstancedCubes(max_instances=130 * 130)
            self.cam_marks = eng.InstancedCubes(max_instances=16)
            self.hdr = eng.HDRPipeline(self.W, self.H)
            fp, fc = reconstruction.generate_grid(64, 64)
            self.floor.set_instances(np.asarray(fp, np.float32),
                                     np.asarray(fc, np.float32))
            cp, cc = reconstruction.get_cam_positions(cams)
            self.cam_marks.set_instances(np.asarray(cp, np.float32),
                                         np.asarray(cc, np.float32))
        except BaseException:
            # the caller gets no object to release the entered context
            self.ctx.__exit__(*sys.exc_info())
            raise

    def render(self, pos, col, eye=(28.0, 26.0, 28.0), pitch=-35.0,
               yaw=-135.0):
        gl, eng = self.gl, self.eng
        self.cubes.set_instances(np.asarray(pos, np.float32),
                                 np.asarray(col, np.float32))
        camera = eng.FlyCamera(position=eye, pitch=pitch, yaw=yaw)
        self.hdr.bind_scene()
        gl.glClearColor(0.05, 0.05, 0.07, 1.0)
        gl.glClear(gl.GL_COLOR_BUFFER_BIT | gl.GL_DEPTH_BUFFER_BIT)
        vp = (eng.perspective(45.0, self.W / self.H, 0.1, 500.0)
              @ camera.view_matrix())
        gl.glUseProgram(self.prog)
        gl.glUniformMatrix4fv(
            gl.glGetUniformLocation(self.prog, "u_view_proj"), 1, True,
            vp.astype(np.float32))
        for mesh, scale in ((self.floor, 1.0), (self.cubes, 0.35),
                            (self.cam_marks, 1.5)):
            gl.glUniform1f(gl.glGetUniformLocation(self.prog, "u_scale"),
                           scale)
            mesh.draw()
        self.hdr.resolve(target_fbo=self.ctx._fbo)
        return self.ctx.read_pixels()

    def close(self):
        self.ctx.__exit__(None, None, None)


def _render_gl_offscreen(pos, col, cams, wh=(1280, 720)):
    """One-shot GL render (see GLSceneRenderer)."""
    r = GLSceneRenderer(cams, wh)
    try:
        return r.render(pos, col)
    finally:
        r.close()


def cmd_pipeline(args):
    """Production loop: prefetching decode → the fused step on the device
    (mask stages, cleanup with kernel K2, carve with kernel K1); per-frame
    latency.  With --offline N, whole-video mode: N frames per launch of
    kernel K4."""
    from vbr_tpu_torch.models.visual_hull import VisualHull
    from vbr_tpu_torch.native import PrefetchingSource
    from vbr_tpu_torch.pipelines import reconstruction
    from vbr_tpu_torch.utils.config import GridConfig

    model = VisualHull.from_data_dir(
        args.data, GridConfig(nx=args.grid, ny=args.grid, nz=args.grid),
        device=_device(args))
    src = PrefetchingSource(
        [os.path.join(args.data, f"cam{i}", "video.avi")
         for i in range(1, 5)])
    if args.offline > 0:
        frames_list = []
        while args.frames <= 0 or len(frames_list) < args.frames:
            frames = src.next_frames()
            if frames is None:
                break
            frames_list.append(frames)
        src.close()
        if not frames_list:
            print("no frames available")
            return
        batch = np.stack(frames_list)
        t0 = time.time()
        occ, colors = model.process_frames_offline(
            batch, frames_per_launch=args.offline)
        dt = time.time() - t0
        print(f"{len(batch)} frames offline ({args.offline}/launch): "
              f"{dt / len(batch) * 1e3:.1f} ms/frame "
              f"({len(batch) / dt:.2f} fps) incl. upload/download")
        if args.ply:
            idx, col = colors[0]
            pos, rgb = _viewer_positions(model.grid.voxel_points(), idx, col,
                                         model.rig)
            reconstruction.write_ply(args.ply, pos, rgb)
            print(f"  wrote {args.ply} ({len(pos)} voxels, frame 0)")
        return

    from vbr_tpu_torch.ops import carve as carve_ops

    times = []
    i = 0
    try:
        while args.frames <= 0 or i < args.frames:
            frames = src.next_frames()
            if frames is None:
                break
            t0 = time.time()
            occ, col = model.process_frame_fast(frames)
            occ[:1].cpu()  # wait for the step
            times.append(time.time() - t0)
            if args.ply and i == 0:
                pos, rgb = carve_ops.compact_voxels(occ, col, model.grid)
                reconstruction.write_ply(args.ply, pos, rgb)
            i += 1
    finally:
        src.close()
    tm = np.array(times[min(3, len(times) - 1):])
    print(f"{len(times)} frames: {tm.mean()*1e3:.0f} ms/frame "
          f"({1/max(tm.mean(), 1e-9):.2f} fps)")


def cmd_view(args):
    from vbr_tpu_torch.utils.config import AppConfig
    from vbr_tpu_torch.viewer import app as viewer_app

    cfg_path = os.path.join(args.data, "..", "config.json")
    cfg = AppConfig.load(cfg_path) if os.path.exists(cfg_path) else AppConfig()
    viewer_app.run_viewer(args.data, cfg, device=_device(args))


def _version() -> str:
    try:
        from importlib.metadata import version

        return version("vbr-tpu")
    except Exception:
        pass
    try:  # an uninstalled checkout: pyproject.toml holds the version
        import re

        with open(os.path.join(_ROOT, "pyproject.toml")) as f:
            m = re.search(r'^version\s*=\s*"([^"]+)"', f.read(), re.M)
        if m:
            return m.group(1) + "+src"
    except Exception:
        pass
    return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vbr_tpu_torch")
    ap.add_argument("--version", action="version",
                    version=f"vbr-tpu-torch {_version()}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("calibrate")
    _add_common(p)
    p.add_argument("--mode", choices=("intrinsics", "extrinsics"),
                   default="intrinsics")
    p.add_argument("--cams", default="1,2,3,4")
    p.add_argument("--video", default="checkerboard.avi")
    p.add_argument("--frame-interval", type=int, default=10)
    p.add_argument("--stop-frame", type=int, default=0)
    p.add_argument("--discard", action="store_true",
                   help="leave-one-out view discarding (reference "
                        "camera_calibration.py:522-563)")
    p.add_argument("--method", choices=("corners", "photometric"),
                   default="corners",
                   help="intrinsics mode: 'corners' = per-frame saddle "
                        "detection + LM (reference parity); 'photometric' "
                        "= detector-free joint gradient fit of K/dist/"
                        "poses on raw board pixels")
    p.add_argument("--photometric-iters", type=int, default=3000)
    p.add_argument("--discard-threshold", type=float, default=0.15)
    p.add_argument("--no-auto", dest="auto", action="store_false",
                   default=True,
                   help="extrinsics mode: disable the full-auto pipeline "
                        "(blob lattice + photometric refinement + 180° "
                        "voting) and use per-frame saddle detection")
    p.add_argument("--no-annotate", dest="annotate", action="store_false",
                   default=True,
                   help="skip corner-overlay audit artifacts "
                        "(*_imagepoints.avi / checkerboard_imagepoints.jpg)")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("masks")
    _add_common(p)
    p.add_argument("--frame", type=int, default=0)
    p.set_defaults(fn=cmd_masks)

    p = sub.add_parser("carve")
    _add_common(p)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--ply", default="")
    p.add_argument("--batched", action="store_true",
                   help="offline multi-frame carve (kernel K4, N frames "
                        "per launch)")
    p.set_defaults(fn=cmd_carve)

    p = sub.add_parser("mesh")
    _add_common(p)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--obj", default="artifacts/hull.obj")
    p.add_argument(
        "--algorithm", choices=("tetrahedra", "cubes"), default="tetrahedra",
        help="tetrahedra: ambiguity-free 6-tet decomposition; cubes: "
        "classic 256-case marching cubes")
    p.add_argument(
        "--ambiguity", choices=("separate", "join"), default="separate",
        help="cubes ambiguous-face rule: separate (6-connected inside) "
        "or join (26-connected)")
    p.set_defaults(fn=cmd_mesh)

    p = sub.add_parser("render")
    _add_common(p)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--png", default="")
    p.add_argument("--gl", action="store_true",
                   help="render through the GL engine (EGL offscreen; needs "
                        "PyOpenGL)")
    p.add_argument(
        "--animate", type=int, default=0, metavar="N",
        help="stream N video frames through the pipeline and encode an "
        "orbit-camera MJPEG AVI (--png names the output, extension "
        "replaced with .avi; GL engine with --gl, splat renderer "
        "otherwise)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("pipeline")
    _add_common(p)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--ply", default="")
    p.add_argument("--offline", type=int, default=0, metavar="N",
                   help="offline whole-video mode: N frames per device "
                        "launch (VisualHull.process_frames_offline)")
    p.set_defaults(fn=cmd_pipeline)

    p = sub.add_parser("view")
    _add_common(p)
    p.set_defaults(fn=cmd_view)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

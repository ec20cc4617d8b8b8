"""The system under test: ``vbr_tpu_torch``'s ``VisualHull`` built as a
configuration states.  The only module of the benchmark that imports the
program."""

from __future__ import annotations


def build(config, inputs, device):
    """A ``VisualHull`` of the configuration's rig on ``device``, its
    background models trained on ``inputs.background`` (kernel K3).
    Raises ``ValueError`` where the program's MOG parameters depart from
    the configuration's."""
    from vbr_tpu_torch.models.visual_hull import VisualHull
    from vbr_tpu_torch.utils.config import (CameraParams, GridConfig,
                                            MaskParams, RigConfig)

    cams = [CameraParams.from_arrays(c["K"], c["dist"], c["rvec"], c["tvec"])
            for c in inputs.cameras]
    H, W = inputs.image_hw
    rig = RigConfig(num_cameras=len(cams), image_height=H, image_width=W,
                    views_threshold=config["views_threshold"],
                    color_camera=config["color_camera"])
    model = VisualHull(
        cams, GridConfig(**config["grid"]), rig,
        [MaskParams(**p) for p in config["mask_params"]],
        device=device)
    model.train_background(list(inputs.background))
    want = dict(config["mog"], history=inputs.background.shape[1])
    for p in model.mog_params:
        got = {k: getattr(p, k) for k in want}
        if got != want:
            raise ValueError(f"the program trains with {got}, the "
                             f"configuration states {want}")
    return model



def count_redos(model) -> dict:
    """Count the program's exact redos of a frame whose device cleanup
    overflowed a component table: wraps the model's two redo entries
    (``_redo`` of the live step, ``process_frame`` of the offline path) on
    this instance.  Returns the counter, ``{"redos": n}``, which the caller
    may reset."""
    counter = {"redos": 0}

    def counted(f):
        def wrapped(*args, **kwargs):
            counter["redos"] += 1
            return f(*args, **kwargs)
        return wrapped

    for name in ("_redo", "process_frame"):
        setattr(model, name, counted(getattr(model, name)))
    return counter

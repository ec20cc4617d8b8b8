"""OpenCV ``FileStorage``-compatible XML I/O, implemented without OpenCV.

The port's own copy of ``vbr_tpu/utils/xmlio.py`` (ElementTree and numpy
only): per-camera ``config.xml`` with CameraMatrix / DistortionCoeffs /
RotationVector / TranslationVector nodes and ``checkerboard.xml`` with
scalar board geometry, in OpenCV's on-disk format (``opencv_storage``
root, ``opencv-matrix`` typed nodes with rows/cols/dt/data children).
``save_storage`` writes the same bytes as the JAX package's, so a rig
written by either package reads the same in both.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

Node = Union[int, float, str, np.ndarray]

_DT_TO_NUMPY = {
    "d": np.float64,
    "f": np.float32,
    "i": np.int32,
    "u": np.uint8,
    "s": np.int16,
}
_NUMPY_TO_DT = {
    np.dtype(np.float64): "d",
    np.dtype(np.float32): "f",
    np.dtype(np.int32): "i",
    np.dtype(np.int64): "i",
    np.dtype(np.uint8): "u",
    np.dtype(np.int16): "s",
}


def _parse_matrix(elem: ET.Element) -> np.ndarray:
    rows = int(elem.findtext("rows"))
    cols = int(elem.findtext("cols"))
    dt = (elem.findtext("dt") or "d").strip()
    data_text = elem.findtext("data") or ""
    # Multi-channel dts look like "3d"; split channels into trailing dim.
    channels = 1
    if len(dt) > 1:
        channels = int(dt[:-1])
        dt = dt[-1]
    dtype = _DT_TO_NUMPY.get(dt, np.float64)
    values = np.array([float(tok) for tok in data_text.split()], dtype=np.float64)
    arr = values.astype(dtype)
    if channels > 1:
        return arr.reshape(rows, cols, channels)
    return arr.reshape(rows, cols)


def _parse_scalar(text: str) -> Union[int, float, str]:
    text = text.strip()
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def load_storage(path: str, names: Optional[List[str]] = None) -> Dict[str, Node]:
    """Read an OpenCV XML storage file into {node name: matrix or scalar}.

    ``names`` optionally restricts which top-level nodes are returned
    (mirrors the node_tags argument of the reference's ``load_xml_nodes``,
    utils.py:115-152).
    """
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "opencv_storage":
        raise ValueError(f"{path}: not an opencv_storage XML file")
    out: Dict[str, Node] = {}
    for child in root:
        if names is not None and child.tag not in names:
            continue
        if child.get("type_id") == "opencv-matrix":
            out[child.tag] = _parse_matrix(child)
        else:
            out[child.tag] = _parse_scalar(child.text or "")
    return out


def _format_value(v: float, dtype: np.dtype) -> str:
    if np.issubdtype(dtype, np.integer):
        return str(int(v))
    # OpenCV writes full-precision scientific notation; "0." for exact zero.
    if v == 0:
        return "0."
    if v == int(v) and abs(v) < 1e16:
        text = f"{v:.0f}."
    else:
        text = np.format_float_scientific(v, precision=16, exp_digits=2)
    return text


def _matrix_element(name: str, arr: np.ndarray) -> ET.Element:
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim == 3:
        rows, cols, ch = arr.shape
        dt = f"{ch}{_NUMPY_TO_DT.get(arr.dtype, 'd')}"
        flat = arr.reshape(-1)
    else:
        rows, cols = arr.shape
        dt = _NUMPY_TO_DT.get(arr.dtype, "d")
        flat = arr.reshape(-1)
    elem = ET.Element(name, {"type_id": "opencv-matrix"})
    ET.SubElement(elem, "rows").text = str(rows)
    ET.SubElement(elem, "cols").text = str(cols)
    ET.SubElement(elem, "dt").text = dt
    tokens = [_format_value(float(v), arr.dtype) for v in flat]
    # Wrap at ~70 chars per line like OpenCV's writer.
    lines, cur = [], ""
    for tok in tokens:
        if cur and len(cur) + 1 + len(tok) > 68:
            lines.append(cur)
            cur = tok
        else:
            cur = tok if not cur else cur + " " + tok
    if cur:
        lines.append(cur)
    ET.SubElement(elem, "data").text = "\n    " + "\n    ".join(lines)
    return elem


def save_storage(path: str, nodes: Mapping[str, Node]) -> None:
    """Write {name: matrix or scalar} in OpenCV FileStorage XML format.

    Output is readable by ``cv2.FileStorage`` and by :func:`load_storage`
    (round-trip tested), matching the reference's ``save_xml_nodes``
    (utils.py:155-174) artifact contract.
    """
    root = ET.Element("opencv_storage")
    for name, value in nodes.items():
        if isinstance(value, np.ndarray):
            root.append(_matrix_element(name, value))
        else:
            elem = ET.SubElement(root, name)
            elem.text = str(value)
    ET.indent(root, space="")
    body = ET.tostring(root, encoding="unicode")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(body)
        f.write("\n")


def load_camera_config(cam_dir: str, filename: str = "config.xml"):
    """Load (K, dist, rvec, tvec) from a per-camera config.xml.

    Same node contract as the reference's ``load_config_info``
    (voxel_reconstruction.py:10-32).
    """
    nodes = load_storage(
        os.path.join(cam_dir, filename),
        ["CameraMatrix", "DistortionCoeffs", "RotationVector", "TranslationVector"],
    )
    return (
        nodes["CameraMatrix"],
        nodes["DistortionCoeffs"],
        nodes["RotationVector"],
        nodes["TranslationVector"],
    )


def save_camera_config(cam_dir: str, K, dist, rvec, tvec, filename: str = "config.xml"):
    """Write a per-camera config.xml (camera_calibration.py:972-974 contract)."""
    save_storage(
        os.path.join(cam_dir, filename),
        {
            "CameraMatrix": np.asarray(K, dtype=np.float64).reshape(3, 3),
            "DistortionCoeffs": np.asarray(dist, dtype=np.float64).reshape(1, -1),
            "RotationVector": np.asarray(rvec, dtype=np.float64).reshape(3, 1),
            "TranslationVector": np.asarray(tvec, dtype=np.float64).reshape(3, 1),
        },
    )


def load_chessboard_info(path: str):
    """Read (inner corner grid (cols, rows), square size mm) from
    checkerboard.xml — reference ``load_chessboard_info``
    (camera_calibration.py:15-35)."""
    nodes = load_storage(path)
    width = int(nodes["CheckerBoardWidth"])
    height = int(nodes["CheckerBoardHeight"])
    square = float(nodes["CheckerBoardSquareSize"])
    return (width, height), square

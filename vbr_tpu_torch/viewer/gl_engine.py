"""Minimal modern-GL engine: shaders, instanced cubes, camera, HDR chain.

The port's own copy of ``vbr_tpu/viewer/gl_engine.py``, the same GL calls
on the same data.  The presentation layer consuming device-computed
arrays: replaces the reference's ``engine/`` package (Shader/Program
wrappers, instanced Mesh with per-instance position+color VBOs at divisor
1, HDR multisampled framebuffer with tonemap).  Written for GL 3.3 core;
only the *live* behavior of the reference is reproduced (flat instance
colors — the reference's Blinn-Phong result is overwritten in its
fragment shader, resources/shaders/frag.fs:78-79 — and its blur shader is
a passthrough, which this engine replaces with a real Gaussian).

The GL-free part (``CUBE_VERTS``, ``perspective``, ``look_at_gl``,
``FlyCamera``, ``ortho``, the tonemap constants and the GLSL sources)
needs numpy only.  PyOpenGL is imported when the module is; without it
the module still imports, and ``compile_program`` and every GL class raise
``ImportError``.  ``load_texture_file`` decodes through PIL (imported
when called).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

try:
    from OpenGL import GL as gl

    HAVE_GL = True
except Exception:  # pragma: no cover - PyOpenGL absent or unloadable
    gl = None
    HAVE_GL = False


def _require_gl():
    if not HAVE_GL:
        raise ImportError(
            "the GL engine needs PyOpenGL (the 'OpenGL' package), which "
            "is not installed or failed to load; headless.render_points "
            "renders without it")


VERT_SRC = """
#version 330 core
layout(location = 0) in vec3 in_pos;
layout(location = 1) in vec3 in_instance_pos;
layout(location = 2) in vec3 in_instance_color;
uniform mat4 u_view_proj;
uniform float u_scale;
out vec3 v_color;
void main() {
    vec3 world = in_pos * u_scale + in_instance_pos;
    gl_Position = u_view_proj * vec4(world, 1.0);
    v_color = in_instance_color;
}
"""

FRAG_SRC = """
#version 330 core
in vec3 v_color;
layout(location = 0) out vec4 out_color;
layout(location = 1) out vec4 out_bright;
void main() {
    out_color = vec4(v_color, 1.0);
    float brightness = dot(v_color, vec3(0.2126, 0.7152, 0.0722));
    out_bright = brightness > 1.0 ? vec4(v_color, 1.0) : vec4(0.0, 0.0, 0.0, 1.0);
}
"""

QUAD_VERT = """
#version 330 core
layout(location = 0) in vec2 in_pos;
out vec2 v_uv;
void main() {
    v_uv = in_pos * 0.5 + 0.5;
    gl_Position = vec4(in_pos, 0.0, 1.0);
}
"""

BLUR_FRAG = """
#version 330 core
in vec2 v_uv;
out vec4 out_color;
uniform sampler2D u_image;
uniform bool u_horizontal;
const float w[5] = float[](0.227027, 0.1945946, 0.1216216, 0.054054, 0.016216);
void main() {
    vec2 texel = 1.0 / vec2(textureSize(u_image, 0));
    vec3 acc = texture(u_image, v_uv).rgb * w[0];
    for (int i = 1; i < 5; ++i) {
        vec2 off = u_horizontal ? vec2(texel.x * i, 0.0) : vec2(0.0, texel.y * i);
        acc += texture(u_image, v_uv + off).rgb * w[i];
        acc += texture(u_image, v_uv - off).rgb * w[i];
    }
    out_color = vec4(acc, 1.0);
}
"""

HDR_FRAG = """
#version 330 core
in vec2 v_uv;
out vec4 out_color;
uniform sampler2D u_scene;
uniform sampler2D u_bloom;
uniform float u_exposure;
uniform float u_gamma;
void main() {
    vec3 hdr = texture(u_scene, v_uv).rgb + texture(u_bloom, v_uv).rgb;
    vec3 mapped = vec3(1.0) - exp(-hdr * u_exposure);
    out_color = vec4(pow(mapped, vec3(1.0 / u_gamma)), 1.0);
}
"""

# Reference tonemap constants (resources/shaders/hdr.fs:13-14 behavior)
EXPOSURE = 0.72
GAMMA = 1.1

CUBE_VERTS = np.array(
    [
        # 36 verts (12 tris), unit cube centered at origin
        -1, -1, -1, 1, -1, -1, 1, 1, -1, 1, 1, -1, -1, 1, -1, -1, -1, -1,
        -1, -1, 1, 1, 1, 1, 1, -1, 1, 1, 1, 1, -1, -1, 1, -1, 1, 1,
        -1, 1, 1, -1, 1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 1, -1, 1, 1,
        1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, -1, 1, 1, 1, 1, -1, 1,
        -1, -1, -1, 1, -1, 1, 1, -1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1,
        -1, 1, -1, 1, 1, -1, 1, 1, 1, 1, 1, 1, -1, 1, 1, -1, 1, -1,
    ],
    dtype=np.float32,
) * 0.5


def perspective(fov_deg, aspect, near, far):
    f = 1.0 / np.tan(np.radians(fov_deg) / 2)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at_gl(eye, center, up):
    eye = np.asarray(eye, np.float32)
    f = np.asarray(center, np.float32) - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float32))
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


class FlyCamera:
    """Pitch/yaw WASD camera (engine/camera.py equivalent: starts above
    the scene pitched down, executable.py:16)."""

    def __init__(self, position=(0.0, 100.0, 0.0), pitch=-90.0, yaw=0.0):
        self.position = np.asarray(position, np.float32)
        self.pitch = pitch
        self.yaw = yaw

    @property
    def front(self):
        cp = np.cos(np.radians(self.pitch))
        return np.array(
            [
                np.cos(np.radians(self.yaw)) * cp,
                np.sin(np.radians(self.pitch)),
                np.sin(np.radians(self.yaw)) * cp,
            ],
            np.float32,
        )

    def rotate(self, dyaw, dpitch):
        self.yaw += dyaw
        self.pitch = float(np.clip(self.pitch + dpitch, -89.9, 89.9))

    def move(self, forward=0.0, right=0.0, speed=1.0):
        f = self.front
        r = np.cross(f, [0, 1, 0])
        r /= max(np.linalg.norm(r), 1e-9)
        self.position = self.position + speed * (forward * f + right * r)

    def view_matrix(self):
        return look_at_gl(self.position, self.position + self.front, (0, 1, 0))


def compile_program(vs_src: str, fs_src: str) -> int:
    _require_gl()
    def compile_shader(src, kind):
        sh = gl.glCreateShader(kind)
        gl.glShaderSource(sh, src)
        gl.glCompileShader(sh)
        if not gl.glGetShaderiv(sh, gl.GL_COMPILE_STATUS):
            raise RuntimeError(gl.glGetShaderInfoLog(sh).decode())
        return sh

    vs = compile_shader(vs_src, gl.GL_VERTEX_SHADER)
    fs = compile_shader(fs_src, gl.GL_FRAGMENT_SHADER)
    prog = gl.glCreateProgram()
    gl.glAttachShader(prog, vs)
    gl.glAttachShader(prog, fs)
    gl.glLinkProgram(prog)
    if not gl.glGetProgramiv(prog, gl.GL_LINK_STATUS):
        raise RuntimeError(gl.glGetProgramInfoLog(prog).decode())
    gl.glDeleteShader(vs)
    gl.glDeleteShader(fs)
    return prog


class InstancedCubes:
    """VAO with static geometry + dynamic per-instance position/color
    VBOs at divisor 1 (engine/renderable/mesh.py:62-67,80-94 equivalent).

    ``geometry``: optional (M, 3) or (T, 3, 3) f32 triangle soup to draw
    per instance instead of the built-in unit cube — used for the
    reference's assimp-JSON cube/square/camera props (executable.py:
    110-112); per-model rotations are pre-baked into the soup."""

    def __init__(self, max_instances: int = 2_200_000,
                 geometry: Optional[np.ndarray] = None):
        _require_gl()
        geom = (CUBE_VERTS if geometry is None
                else np.ascontiguousarray(geometry, np.float32).reshape(-1))
        self.n_verts = len(geom) // 3
        self.max_instances = max_instances
        self.count = 0
        self.vao = gl.glGenVertexArrays(1)
        gl.glBindVertexArray(self.vao)

        self.vbo_geom = gl.glGenBuffers(1)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo_geom)
        gl.glBufferData(gl.GL_ARRAY_BUFFER, geom.nbytes, geom,
                        gl.GL_STATIC_DRAW)
        gl.glEnableVertexAttribArray(0)
        gl.glVertexAttribPointer(0, 3, gl.GL_FLOAT, False, 12, None)

        self.vbo_pos = gl.glGenBuffers(1)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo_pos)
        gl.glBufferData(gl.GL_ARRAY_BUFFER, max_instances * 12, None,
                        gl.GL_DYNAMIC_DRAW)
        gl.glEnableVertexAttribArray(1)
        gl.glVertexAttribPointer(1, 3, gl.GL_FLOAT, False, 12, None)
        gl.glVertexAttribDivisor(1, 1)

        self.vbo_col = gl.glGenBuffers(1)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo_col)
        gl.glBufferData(gl.GL_ARRAY_BUFFER, max_instances * 12, None,
                        gl.GL_DYNAMIC_DRAW)
        gl.glEnableVertexAttribArray(2)
        gl.glVertexAttribPointer(2, 3, gl.GL_FLOAT, False, 12, None)
        gl.glVertexAttribDivisor(2, 1)
        gl.glBindVertexArray(0)

    def set_instances(self, positions: np.ndarray, colors: np.ndarray):
        positions = np.ascontiguousarray(positions, np.float32)
        colors = np.ascontiguousarray(colors, np.float32)
        self.count = min(len(positions), self.max_instances)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo_pos)
        gl.glBufferSubData(gl.GL_ARRAY_BUFFER, 0, positions[: self.count].nbytes,
                           positions[: self.count])
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo_col)
        gl.glBufferSubData(gl.GL_ARRAY_BUFFER, 0, colors[: self.count].nbytes,
                           colors[: self.count])

    def draw(self):
        if self.count:
            gl.glBindVertexArray(self.vao)
            gl.glDrawArraysInstanced(gl.GL_TRIANGLES, 0, self.n_verts,
                                     self.count)
            gl.glBindVertexArray(0)


MESH_VERT = """
#version 330 core
layout(location = 0) in vec3 in_pos;
layout(location = 1) in vec3 in_normal;
uniform mat4 u_view_proj;
out vec3 v_normal;
void main() {
    gl_Position = u_view_proj * vec4(in_pos, 1.0);
    v_normal = in_normal;
}
"""

MESH_FRAG = """
#version 330 core
in vec3 v_normal;
uniform vec3 u_color;
layout(location = 0) out vec4 out_color;
layout(location = 1) out vec4 out_bright;
void main() {
    vec3 n = normalize(v_normal);
    vec3 light = normalize(vec3(0.4, 1.0, 0.3));
    float diff = max(dot(n, light), 0.0) * 0.7 + 0.3;
    out_color = vec4(u_color * diff, 1.0);
    out_bright = vec4(0.0, 0.0, 0.0, 1.0);
}
"""


class StaticMesh:
    """Flat-shaded triangle-soup mesh (the marching-cubes surface display
    mode — an upgrade over the reference, whose marching-cubes output only
    ever went to a matplotlib PNG, voxel_reconstruction.py:127-163)."""

    def __init__(self, color=(0.85, 0.75, 0.6)):
        _require_gl()
        self.color = np.asarray(color, np.float32)
        self.count = 0
        self.capacity = 0
        self.prog = compile_program(MESH_VERT, MESH_FRAG)
        self.vao = gl.glGenVertexArrays(1)
        self.vbo = gl.glGenBuffers(1)
        gl.glBindVertexArray(self.vao)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo)
        gl.glEnableVertexAttribArray(0)
        gl.glVertexAttribPointer(0, 3, gl.GL_FLOAT, False, 24, None)
        gl.glEnableVertexAttribArray(1)
        gl.glVertexAttribPointer(1, 3, gl.GL_FLOAT, False, 24,
                                 ctypes.c_void_p(12))
        gl.glBindVertexArray(0)

    def set_triangles(self, tris: np.ndarray):
        """tris (T, 3, 3) f32 in viewer coords; flat per-face normals."""
        tris = np.ascontiguousarray(tris, np.float32)
        if len(tris) == 0:
            self.count = 0
            return
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        inter = np.empty((len(tris), 3, 6), np.float32)
        inter[:, :, :3] = tris
        inter[:, :, 3:] = n[:, None, :]
        flat = inter.reshape(-1)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo)
        if flat.nbytes > self.capacity:
            gl.glBufferData(gl.GL_ARRAY_BUFFER, flat.nbytes, flat,
                            gl.GL_DYNAMIC_DRAW)
            self.capacity = flat.nbytes
        else:
            gl.glBufferSubData(gl.GL_ARRAY_BUFFER, 0, flat.nbytes, flat)
        self.count = len(tris) * 3

    def draw(self, view_proj: np.ndarray):
        if not self.count:
            return
        gl.glUseProgram(self.prog)
        gl.glUniformMatrix4fv(
            gl.glGetUniformLocation(self.prog, "u_view_proj"), 1, True,
            view_proj.astype(np.float32),
        )
        gl.glUniform3fv(gl.glGetUniformLocation(self.prog, "u_color"), 1,
                        self.color)
        gl.glBindVertexArray(self.vao)
        gl.glDrawArrays(gl.GL_TRIANGLES, 0, self.count)
        gl.glBindVertexArray(0)


TEX_MESH_VERT = """
#version 330 core
layout(location = 0) in vec3 in_pos;
layout(location = 1) in vec3 in_normal;
layout(location = 2) in vec2 in_uv;
uniform mat4 u_view_proj;
out vec3 v_normal;
out vec2 v_uv;
void main() {
    gl_Position = u_view_proj * vec4(in_pos, 1.0);
    v_normal = in_normal;
    v_uv = in_uv;
}
"""

TEX_MESH_FRAG = """
#version 330 core
in vec3 v_normal;
in vec2 v_uv;
uniform sampler2D u_tex;
layout(location = 0) out vec4 out_color;
layout(location = 1) out vec4 out_bright;
void main() {
    vec3 n = normalize(v_normal);
    vec3 light = normalize(vec3(0.4, 1.0, 0.3));
    float diff = max(dot(n, light), 0.0) * 0.7 + 0.3;
    out_color = vec4(texture(u_tex, v_uv).rgb * diff, 1.0);
    out_bright = vec4(0.0, 0.0, 0.0, 1.0);
}
"""


class Texture2D:
    """Mipmapped 2D texture (reference engine/buffer/texture.py:31-45:
    RGBA upload, generated mipmaps, REPEAT wrap, trilinear min filter)."""

    def __init__(self, rgba: np.ndarray):
        _require_gl()
        rgba = np.ascontiguousarray(rgba, np.uint8)
        if rgba.ndim != 3 or rgba.shape[2] != 4:
            raise ValueError("Texture2D wants (H, W, 4) u8 RGBA")
        h, w = rgba.shape[:2]
        self.tex = gl.glGenTextures(1)
        gl.glBindTexture(gl.GL_TEXTURE_2D, self.tex)
        gl.glTexImage2D(gl.GL_TEXTURE_2D, 0, gl.GL_RGBA, w, h, 0,
                        gl.GL_RGBA, gl.GL_UNSIGNED_BYTE, rgba)
        gl.glGenerateMipmap(gl.GL_TEXTURE_2D)
        gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_WRAP_S,
                           gl.GL_REPEAT)
        gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_WRAP_T,
                           gl.GL_REPEAT)
        gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MIN_FILTER,
                           gl.GL_LINEAR_MIPMAP_LINEAR)
        gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MAG_FILTER,
                           gl.GL_LINEAR)
        gl.glBindTexture(gl.GL_TEXTURE_2D, 0)

    def bind(self, unit: int = 0):
        gl.glActiveTexture(gl.GL_TEXTURE0 + unit)
        gl.glBindTexture(gl.GL_TEXTURE_2D, self.tex)

    def delete(self):
        if self.tex:
            gl.glDeleteTextures(1, [self.tex])
            self.tex = 0


def load_texture_file(path: str):
    """File → :class:`Texture2D` (PIL decode to RGBA, bottom-up like the
    reference's PIL FLIP_TOP_BOTTOM).  None when absent or undecodable —
    callers degrade to the flat-color prop path (e.g. a checkout whose
    LFS-stored diffuse.jpg was not fetched).

    ``vbr_tpu`` decodes through cv2 and reorders BGR(A) → RGBA; PIL gives
    the same RGBA texels for a PNG (a JPEG may differ by the two libjpeg
    builds' rounding).  A grey image is replicated into RGB, and an image
    without alpha gets 255."""
    if not os.path.exists(path):
        return None
    from PIL import Image

    try:
        with Image.open(path) as im:
            im.load()
            if im.mode not in ("L", "RGB", "RGBA"):
                alpha = "A" in im.getbands() or "transparency" in im.info
                im = im.convert("RGBA" if alpha else "RGB")
            img = np.asarray(im, np.uint8)
    except (OSError, ValueError):  # PIL.UnidentifiedImageError is an OSError
        return None
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[2] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return Texture2D(img[::-1])


class TexturedMesh:
    """Triangle soup with UVs + a diffuse texture (the assimp-prop path
    the reference drives through engine/renderable/model.py +
    texture.py).  Interleaved pos/normal/uv,
    flat per-face normals like StaticMesh."""

    def __init__(self):
        _require_gl()
        self.count = 0
        self.capacity = 0
        self.prog = compile_program(TEX_MESH_VERT, TEX_MESH_FRAG)
        self.vao = gl.glGenVertexArrays(1)
        self.vbo = gl.glGenBuffers(1)
        gl.glBindVertexArray(self.vao)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo)
        stride = 32  # 3 pos + 3 normal + 2 uv floats
        gl.glEnableVertexAttribArray(0)
        gl.glVertexAttribPointer(0, 3, gl.GL_FLOAT, False, stride, None)
        gl.glEnableVertexAttribArray(1)
        gl.glVertexAttribPointer(1, 3, gl.GL_FLOAT, False, stride,
                                 ctypes.c_void_p(12))
        gl.glEnableVertexAttribArray(2)
        gl.glVertexAttribPointer(2, 2, gl.GL_FLOAT, False, stride,
                                 ctypes.c_void_p(24))
        gl.glBindVertexArray(0)

    def set_triangles(self, tris: np.ndarray, uvs: np.ndarray):
        """tris (T, 3, 3) f32 viewer coords; uvs (T, 3, 2) f32."""
        tris = np.ascontiguousarray(tris, np.float32)
        uvs = np.ascontiguousarray(uvs, np.float32)
        if len(tris) == 0:
            self.count = 0
            return
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        inter = np.empty((len(tris), 3, 8), np.float32)
        inter[:, :, :3] = tris
        inter[:, :, 3:6] = n[:, None, :]
        inter[:, :, 6:8] = uvs
        flat = inter.reshape(-1)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo)
        if flat.nbytes > self.capacity:
            gl.glBufferData(gl.GL_ARRAY_BUFFER, flat.nbytes, flat,
                            gl.GL_DYNAMIC_DRAW)
            self.capacity = flat.nbytes
        else:
            gl.glBufferSubData(gl.GL_ARRAY_BUFFER, 0, flat.nbytes, flat)
        self.count = len(tris) * 3

    def draw(self, view_proj: np.ndarray, texture: Texture2D):
        if not self.count:
            return
        gl.glUseProgram(self.prog)
        gl.glUniformMatrix4fv(
            gl.glGetUniformLocation(self.prog, "u_view_proj"), 1, True,
            view_proj.astype(np.float32),
        )
        texture.bind(0)
        gl.glUniform1i(gl.glGetUniformLocation(self.prog, "u_tex"), 0)
        gl.glBindVertexArray(self.vao)
        gl.glDrawArrays(gl.GL_TRIANGLES, 0, self.count)
        gl.glBindVertexArray(0)


LINE_VERT = """
#version 330 core
layout(location = 0) in vec3 in_pos;
uniform mat4 u_view_proj;
void main() { gl_Position = u_view_proj * vec4(in_pos, 1.0); }
"""

LINE_FRAG = """
#version 330 core
uniform vec3 u_color;
layout(location = 0) out vec4 out_color;
layout(location = 1) out vec4 out_bright;
void main() {
    out_color = vec4(u_color, 1.0);
    out_bright = vec4(0.0, 0.0, 0.0, 1.0);
}
"""


class Lines:
    """GL_LINES renderable (camera frustum wireframes)."""

    def __init__(self, color=(0.7, 0.7, 0.75)):
        _require_gl()
        self.color = np.asarray(color, np.float32)
        self.count = 0
        self.prog = compile_program(LINE_VERT, LINE_FRAG)
        self.vao = gl.glGenVertexArrays(1)
        self.vbo = gl.glGenBuffers(1)
        gl.glBindVertexArray(self.vao)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo)
        gl.glEnableVertexAttribArray(0)
        gl.glVertexAttribPointer(0, 3, gl.GL_FLOAT, False, 12, None)
        gl.glBindVertexArray(0)

    def set_segments(self, segs: np.ndarray):
        """segs (S, 2, 3) f32 viewer-coordinate line segments."""
        flat = np.ascontiguousarray(segs, np.float32).reshape(-1)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, self.vbo)
        gl.glBufferData(gl.GL_ARRAY_BUFFER, flat.nbytes, flat,
                        gl.GL_DYNAMIC_DRAW)
        self.count = len(flat) // 3

    def draw(self, view_proj: np.ndarray):
        if not self.count:
            return
        gl.glUseProgram(self.prog)
        gl.glUniformMatrix4fv(
            gl.glGetUniformLocation(self.prog, "u_view_proj"), 1, True,
            view_proj.astype(np.float32),
        )
        gl.glUniform3fv(gl.glGetUniformLocation(self.prog, "u_color"), 1,
                        self.color)
        gl.glBindVertexArray(self.vao)
        gl.glDrawArrays(gl.GL_LINES, 0, self.count)
        gl.glBindVertexArray(0)


class HDRPipeline:
    """RGB16F scene+bright framebuffer → ping-pong Gaussian bloom →
    exposure/gamma tonemap to the default framebuffer
    (engine/buffer/hdrbuffer.py + effect/bloom.py equivalent).

    With ``samples > 1`` the scene renders into a multisampled twin FBO
    (GL_TEXTURE_2D_MULTISAMPLE color attachments + multisampled depth
    RBO) that is blit-resolved per attachment into the single-sample
    textures before bloom/tonemap — the reference's
    engine/buffer/hdrbuffer.py:38-70 finalize() path, sample count from
    config.json ``sampling_level``."""

    def __init__(self, width: int, height: int, blur_passes: int = 10,
                 samples: int = 0):
        _require_gl()
        self.w, self.h = width, height
        self.blur_passes = blur_passes
        self.samples = int(samples) if samples and samples > 1 else 0
        self.fbo = gl.glGenFramebuffers(1)
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self.fbo)
        self.tex_scene, self.tex_bright = gl.glGenTextures(2)
        for i, tex in enumerate((self.tex_scene, self.tex_bright)):
            gl.glBindTexture(gl.GL_TEXTURE_2D, tex)
            gl.glTexImage2D(gl.GL_TEXTURE_2D, 0, gl.GL_RGB16F, width, height,
                            0, gl.GL_RGB, gl.GL_FLOAT, None)
            gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MIN_FILTER,
                               gl.GL_LINEAR)
            gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MAG_FILTER,
                               gl.GL_LINEAR)
            gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_WRAP_S,
                               gl.GL_CLAMP_TO_EDGE)
            gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_WRAP_T,
                               gl.GL_CLAMP_TO_EDGE)
            gl.glFramebufferTexture2D(
                gl.GL_FRAMEBUFFER, gl.GL_COLOR_ATTACHMENT0 + i,
                gl.GL_TEXTURE_2D, tex, 0,
            )
        self.rbo = gl.glGenRenderbuffers(1)
        gl.glBindRenderbuffer(gl.GL_RENDERBUFFER, self.rbo)
        gl.glRenderbufferStorage(gl.GL_RENDERBUFFER, gl.GL_DEPTH_COMPONENT24,
                                 width, height)
        gl.glFramebufferRenderbuffer(gl.GL_FRAMEBUFFER, gl.GL_DEPTH_ATTACHMENT,
                                     gl.GL_RENDERBUFFER, self.rbo)
        gl.glDrawBuffers(2, [gl.GL_COLOR_ATTACHMENT0, gl.GL_COLOR_ATTACHMENT1])

        if self.samples:
            # multisampled twin (scene renders here, blit-resolved into
            # the single-sample FBO above)
            self.fbo_ms = gl.glGenFramebuffers(1)
            gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self.fbo_ms)
            self.tex_ms = gl.glGenTextures(2)
            for i in range(2):
                gl.glBindTexture(gl.GL_TEXTURE_2D_MULTISAMPLE,
                                 self.tex_ms[i])
                gl.glTexImage2DMultisample(
                    gl.GL_TEXTURE_2D_MULTISAMPLE, self.samples,
                    gl.GL_RGB16F, width, height, gl.GL_TRUE,
                )
                gl.glFramebufferTexture2D(
                    gl.GL_FRAMEBUFFER, gl.GL_COLOR_ATTACHMENT0 + i,
                    gl.GL_TEXTURE_2D_MULTISAMPLE, self.tex_ms[i], 0,
                )
            self.rbo_ms = gl.glGenRenderbuffers(1)
            gl.glBindRenderbuffer(gl.GL_RENDERBUFFER, self.rbo_ms)
            gl.glRenderbufferStorageMultisample(
                gl.GL_RENDERBUFFER, self.samples, gl.GL_DEPTH_COMPONENT24,
                width, height,
            )
            gl.glFramebufferRenderbuffer(
                gl.GL_FRAMEBUFFER, gl.GL_DEPTH_ATTACHMENT,
                gl.GL_RENDERBUFFER, self.rbo_ms,
            )
            gl.glDrawBuffers(
                2, [gl.GL_COLOR_ATTACHMENT0, gl.GL_COLOR_ATTACHMENT1]
            )
            status = gl.glCheckFramebufferStatus(gl.GL_FRAMEBUFFER)
            if status != gl.GL_FRAMEBUFFER_COMPLETE:
                # driver without multisample support: degrade gracefully —
                # free the partially-built MS objects and leave the
                # single-sample FBO bound (ADVICE r3: the incomplete FBO
                # must not stay bound nor leak)
                gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self.fbo)
                gl.glDeleteFramebuffers(1, [self.fbo_ms])
                gl.glDeleteTextures(2, self.tex_ms)
                gl.glDeleteRenderbuffers(1, [self.rbo_ms])
                del self.fbo_ms, self.tex_ms, self.rbo_ms
                self.samples = 0

        # ping-pong blur buffers
        self.pp_fbo = gl.glGenFramebuffers(2)
        self.pp_tex = gl.glGenTextures(2)
        for i in range(2):
            gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self.pp_fbo[i])
            gl.glBindTexture(gl.GL_TEXTURE_2D, self.pp_tex[i])
            gl.glTexImage2D(gl.GL_TEXTURE_2D, 0, gl.GL_RGB16F, width, height,
                            0, gl.GL_RGB, gl.GL_FLOAT, None)
            gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MIN_FILTER,
                               gl.GL_LINEAR)
            gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MAG_FILTER,
                               gl.GL_LINEAR)
            gl.glFramebufferTexture2D(gl.GL_FRAMEBUFFER, gl.GL_COLOR_ATTACHMENT0,
                                      gl.GL_TEXTURE_2D, self.pp_tex[i], 0)
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, 0)

        self.prog_blur = compile_program(QUAD_VERT, BLUR_FRAG)
        self.prog_hdr = compile_program(QUAD_VERT, HDR_FRAG)
        quad = np.array([-1, -1, 1, -1, -1, 1, 1, 1], np.float32)
        self.quad_vao = gl.glGenVertexArrays(1)
        vbo = gl.glGenBuffers(1)
        gl.glBindVertexArray(self.quad_vao)
        gl.glBindBuffer(gl.GL_ARRAY_BUFFER, vbo)
        gl.glBufferData(gl.GL_ARRAY_BUFFER, quad.nbytes, quad, gl.GL_STATIC_DRAW)
        gl.glEnableVertexAttribArray(0)
        gl.glVertexAttribPointer(0, 2, gl.GL_FLOAT, False, 8, None)
        gl.glBindVertexArray(0)

    def bind_scene(self):
        gl.glBindFramebuffer(
            gl.GL_FRAMEBUFFER, self.fbo_ms if self.samples else self.fbo
        )
        gl.glViewport(0, 0, self.w, self.h)

    def _resolve_msaa(self):
        """Blit both MS color attachments into the single-sample FBO
        (reference hdrbuffer.finalize, engine/buffer/hdrbuffer.py:60-70)."""
        gl.glBindFramebuffer(gl.GL_READ_FRAMEBUFFER, self.fbo_ms)
        gl.glBindFramebuffer(gl.GL_DRAW_FRAMEBUFFER, self.fbo)
        for i in range(2):
            gl.glReadBuffer(gl.GL_COLOR_ATTACHMENT0 + i)
            gl.glDrawBuffer(gl.GL_COLOR_ATTACHMENT0 + i)
            gl.glBlitFramebuffer(0, 0, self.w, self.h, 0, 0, self.w, self.h,
                                 gl.GL_COLOR_BUFFER_BIT, gl.GL_NEAREST)
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self.fbo)
        gl.glDrawBuffers(2, [gl.GL_COLOR_ATTACHMENT0, gl.GL_COLOR_ATTACHMENT1])

    def _draw_quad(self):
        gl.glBindVertexArray(self.quad_vao)
        gl.glDrawArrays(gl.GL_TRIANGLE_STRIP, 0, 4)
        gl.glBindVertexArray(0)

    def resolve(self, target_fbo: int = 0):
        """Bloom + tonemap into ``target_fbo`` (0 = window backbuffer)."""
        if self.samples:
            self._resolve_msaa()
        gl.glDisable(gl.GL_DEPTH_TEST)
        horizontal = True
        first = True
        gl.glUseProgram(self.prog_blur)
        for _ in range(self.blur_passes):
            gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self.pp_fbo[int(horizontal)])
            gl.glUniform1i(
                gl.glGetUniformLocation(self.prog_blur, "u_horizontal"),
                int(horizontal),
            )
            gl.glActiveTexture(gl.GL_TEXTURE0)
            gl.glBindTexture(
                gl.GL_TEXTURE_2D,
                self.tex_bright if first else self.pp_tex[int(not horizontal)],
            )
            self._draw_quad()
            horizontal = not horizontal
            first = False

        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, target_fbo)
        gl.glClear(gl.GL_COLOR_BUFFER_BIT)
        gl.glUseProgram(self.prog_hdr)
        gl.glUniform1f(gl.glGetUniformLocation(self.prog_hdr, "u_exposure"),
                       EXPOSURE)
        gl.glUniform1f(gl.glGetUniformLocation(self.prog_hdr, "u_gamma"), GAMMA)
        gl.glUniform1i(gl.glGetUniformLocation(self.prog_hdr, "u_scene"), 0)
        gl.glUniform1i(gl.glGetUniformLocation(self.prog_hdr, "u_bloom"), 1)
        gl.glActiveTexture(gl.GL_TEXTURE0)
        gl.glBindTexture(gl.GL_TEXTURE_2D, self.tex_scene)
        gl.glActiveTexture(gl.GL_TEXTURE1)
        gl.glBindTexture(gl.GL_TEXTURE_2D, self.pp_tex[int(not horizontal)])
        self._draw_quad()
        gl.glEnable(gl.GL_DEPTH_TEST)


SHADOW_DEPTH_VERT = """
#version 330 core
layout(location = 0) in vec3 in_pos;
layout(location = 1) in vec3 in_instance_pos;
uniform mat4 u_light_space;
uniform float u_scale;
void main() {
    gl_Position = u_light_space * vec4(in_pos * u_scale + in_instance_pos, 1.0);
}
"""

SHADOW_DEPTH_FRAG = """
#version 330 core
void main() {}  // depth-only pass
"""


def ortho(left, right, bottom, top, near, far):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2 / (right - left)
    m[1, 1] = 2 / (top - bottom)
    m[2, 2] = -2 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(far + near) / (far - near)
    return m


class ShadowPipeline:
    """Orthographic light-space depth pass (shadow mapping).

    Functional counterpart of the reference's engine/effect/shadow.py —
    which is scaffolding that executable.py never instantiates (its
    fragment shader's shadow term is overwritten by the flat instance
    color, SURVEY.md §2 row 22).  Provided here as a working component:
    render the scene into the depth texture with ``bind``/``unbind`` and
    sample it in a lighting shader via ``light_space`` and ``depth_tex``.
    """

    def __init__(self, size: int = 2048,
                 light_pos=(30.0, 60.0, 30.0), extent: float = 80.0):
        _require_gl()
        self.size = size
        self.light_space = (
            ortho(-extent, extent, -extent, extent, 1.0, 200.0)
            @ look_at_gl(light_pos, (0, 0, 0), (0, 1, 0))
        )
        self.fbo = gl.glGenFramebuffers(1)
        self.depth_tex = gl.glGenTextures(1)
        gl.glBindTexture(gl.GL_TEXTURE_2D, self.depth_tex)
        gl.glTexImage2D(gl.GL_TEXTURE_2D, 0, gl.GL_DEPTH_COMPONENT24, size,
                        size, 0, gl.GL_DEPTH_COMPONENT, gl.GL_FLOAT, None)
        for p, v in (
            (gl.GL_TEXTURE_MIN_FILTER, gl.GL_NEAREST),
            (gl.GL_TEXTURE_MAG_FILTER, gl.GL_NEAREST),
            (gl.GL_TEXTURE_WRAP_S, gl.GL_CLAMP_TO_BORDER),
            (gl.GL_TEXTURE_WRAP_T, gl.GL_CLAMP_TO_BORDER),
        ):
            gl.glTexParameteri(gl.GL_TEXTURE_2D, p, v)
        gl.glTexParameterfv(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_BORDER_COLOR,
                            np.ones(4, np.float32))
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self.fbo)
        gl.glFramebufferTexture2D(gl.GL_FRAMEBUFFER, gl.GL_DEPTH_ATTACHMENT,
                                  gl.GL_TEXTURE_2D, self.depth_tex, 0)
        gl.glDrawBuffer(gl.GL_NONE)
        gl.glReadBuffer(gl.GL_NONE)
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, 0)
        self.prog = compile_program(SHADOW_DEPTH_VERT, SHADOW_DEPTH_FRAG)

    def bind(self):
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self.fbo)
        gl.glViewport(0, 0, self.size, self.size)
        gl.glClear(gl.GL_DEPTH_BUFFER_BIT)
        gl.glUseProgram(self.prog)
        gl.glUniformMatrix4fv(
            gl.glGetUniformLocation(self.prog, "u_light_space"), 1, True,
            self.light_space.astype(np.float32),
        )

    def unbind(self, viewport_wh):
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, 0)
        gl.glViewport(0, 0, *viewport_wh)

"""Offscreen OpenGL context via EGL surfaceless (software rasterizer OK).

The port's own copy of ``vbr_tpu/viewer/offscreen.py``; PyOpenGL's EGL
and GL are imported when the context is entered, never with the module.
Lets the *real* GL engine (shaders, instanced draws, HDR chain) run and be
verified without a display — CI drives the same code path the interactive
GLFW viewer uses.

Usage:
    with OffscreenContext(1280, 720) as ctx:
        ... gl_engine calls ...
        img = ctx.read_pixels()
"""

from __future__ import annotations

import ctypes
import os

import numpy as np


class OffscreenContext:
    def __init__(self, width: int, height: int):
        os.environ.setdefault("EGL_PLATFORM", "surfaceless")
        os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
        os.environ.setdefault("LIBGL_ALWAYS_SOFTWARE", "1")
        self.width = width
        self.height = height
        self._fbo = None

    def __enter__(self):
        from OpenGL import EGL
        from OpenGL.EGL import (
            EGL_CONTEXT_MAJOR_VERSION,
            EGL_CONTEXT_MINOR_VERSION,
            EGL_CONTEXT_OPENGL_CORE_PROFILE_BIT,
            EGL_CONTEXT_OPENGL_PROFILE_MASK,
            EGL_DEFAULT_DISPLAY,
            EGL_NO_CONTEXT,
            EGL_NO_SURFACE,
            EGL_NONE,
            EGL_OPENGL_API,
            EGL_OPENGL_BIT,
            EGL_PBUFFER_BIT,
            EGL_RENDERABLE_TYPE,
            EGL_SURFACE_TYPE,
            eglBindAPI,
            eglChooseConfig,
            eglCreateContext,
            eglGetDisplay,
            eglInitialize,
            eglMakeCurrent,
        )

        self._egl = EGL
        dpy = eglGetDisplay(EGL_DEFAULT_DISPLAY)
        major, minor = ctypes.c_long(), ctypes.c_long()
        if not eglInitialize(dpy, major, minor):
            raise RuntimeError("eglInitialize failed (no EGL support)")
        self._dpy = dpy
        cfg_attribs = [
            EGL_SURFACE_TYPE, EGL_PBUFFER_BIT,
            EGL_RENDERABLE_TYPE, EGL_OPENGL_BIT,
            EGL_NONE,
        ]
        configs = (EGL.EGLConfig * 4)()
        num = ctypes.c_long()
        eglChooseConfig(
            dpy, (ctypes.c_int * len(cfg_attribs))(*cfg_attribs), configs, 4, num
        )
        if num.value < 1:
            raise RuntimeError("no EGL config")
        eglBindAPI(EGL_OPENGL_API)
        ctx_attribs = [
            EGL_CONTEXT_MAJOR_VERSION, 3,
            EGL_CONTEXT_MINOR_VERSION, 3,
            EGL_CONTEXT_OPENGL_PROFILE_MASK, EGL_CONTEXT_OPENGL_CORE_PROFILE_BIT,
            EGL_NONE,
        ]
        ctx = eglCreateContext(
            dpy, configs[0], EGL_NO_CONTEXT,
            (ctypes.c_int * len(ctx_attribs))(*ctx_attribs),
        )
        if not ctx:
            raise RuntimeError("eglCreateContext failed")
        if not eglMakeCurrent(dpy, EGL_NO_SURFACE, EGL_NO_SURFACE, ctx):
            raise RuntimeError("eglMakeCurrent failed")
        self._ctx = ctx

        # default draw target: an FBO standing in for the window backbuffer
        from OpenGL import GL as gl

        self._fbo = gl.glGenFramebuffers(1)
        self._color = gl.glGenRenderbuffers(1)
        self._depth = gl.glGenRenderbuffers(1)
        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self._fbo)
        gl.glBindRenderbuffer(gl.GL_RENDERBUFFER, self._color)
        gl.glRenderbufferStorage(
            gl.GL_RENDERBUFFER, gl.GL_RGBA8, self.width, self.height
        )
        gl.glFramebufferRenderbuffer(
            gl.GL_FRAMEBUFFER, gl.GL_COLOR_ATTACHMENT0, gl.GL_RENDERBUFFER,
            self._color,
        )
        gl.glBindRenderbuffer(gl.GL_RENDERBUFFER, self._depth)
        gl.glRenderbufferStorage(
            gl.GL_RENDERBUFFER, gl.GL_DEPTH_COMPONENT24, self.width, self.height
        )
        gl.glFramebufferRenderbuffer(
            gl.GL_FRAMEBUFFER, gl.GL_DEPTH_ATTACHMENT, gl.GL_RENDERBUFFER,
            self._depth,
        )
        gl.glViewport(0, 0, self.width, self.height)
        return self

    def bind_default(self):
        """Bind the backbuffer-substitute FBO (use instead of FBO 0)."""
        from OpenGL import GL as gl

        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self._fbo)
        gl.glViewport(0, 0, self.width, self.height)

    def read_pixels(self) -> np.ndarray:
        from OpenGL import GL as gl

        gl.glBindFramebuffer(gl.GL_FRAMEBUFFER, self._fbo)
        data = gl.glReadPixels(
            0, 0, self.width, self.height, gl.GL_RGB, gl.GL_UNSIGNED_BYTE
        )
        img = np.frombuffer(data, np.uint8).reshape(self.height, self.width, 3)
        return img[::-1]  # GL origin is bottom-left

    def __exit__(self, *exc):
        try:
            from OpenGL.EGL import eglMakeCurrent, eglTerminate, EGL_NO_SURFACE, EGL_NO_CONTEXT

            eglMakeCurrent(self._dpy, EGL_NO_SURFACE, EGL_NO_SURFACE, EGL_NO_CONTEXT)
        except Exception:
            pass
        return False

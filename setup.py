"""Build hook: ship the C++ native ingest sources inside the wheel.

The sdist already carries ``native/`` via MANIFEST.in, but a wheel built
from this tree would otherwise install only the ``streamz_tpu`` package —
and the ctypes loader would silently fall back to pure-Python ingest
(behavior-identical, a large perf cliff).  This
copies the sources into ``streamz_tpu/native/`` in the built wheel so
``pip install .`` keeps the fast path: ``streamz_tpu/io/native.py`` probes
that directory second and builds the .so there on first use.
"""

import os
import shutil

from setuptools import setup
from setuptools.command.build_py import build_py

NATIVE_FILES = ("Makefile", "streamz_native.cpp", "resample.h")


class BuildPyWithNative(build_py):
    def run(self):
        super().run()
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
        dst = os.path.join(self.build_lib, "streamz_tpu", "native")
        os.makedirs(dst, exist_ok=True)
        for name in NATIVE_FILES:
            shutil.copy2(os.path.join(src, name), os.path.join(dst, name))


setup(cmdclass={"build_py": BuildPyWithNative})

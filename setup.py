"""Build the native host core into the wheel.

The C++ core (tiktoken_tpu/native/core.cpp) is loaded via ctypes, so it
is compiled as a plain shared library named like an extension module and
shipped inside the package — a pip install gets the fast host engine
with no compiler on the target machine (mirroring the reference's
prebuilt-native wheels, reference: setup.py:6-15,
.github/workflows/build_wheels.yml:19-43).

If no toolchain is available at build time the wheel still builds: the
runtime falls back to lazy g++ compilation (or the pure-Python engine),
exactly as before.

The same ``build_ext`` builds the PyTorch port's compiled parts into
``tiktoken_tpu_torch/prebuilt/`` of the wheel (of the source tree with
``--inplace``): its native core with g++, and its seven CUDA kernel
libraries where ``nvcc`` is found, by ``tiktoken_tpu_torch/_build.py``,
loaded by its path so that building imports no torch. A missing compiler
leaves that part out of the wheel; the port then builds it at first use
or, for the core, runs its pure-Python encoder.
"""

from __future__ import annotations

import importlib.util
import os
import platform

from setuptools import Extension, setup
from setuptools.command.build_ext import build_ext


class OptionalBuildExt(build_ext):
    """Best-effort native build: a missing/broken toolchain degrades to a
    pure-Python wheel instead of failing the install."""

    def run(self):  # noqa: D102
        try:
            super().run()
        except Exception as e:  # pragma: no cover - toolchain-dependent
            self.warn(f"native core build skipped ({e}); runtime will "
                      f"compile lazily or use the pure-Python engine")

    def build_extension(self, ext):  # noqa: D102
        try:
            super().build_extension(ext)
        except Exception as e:  # pragma: no cover
            self.warn(f"native core build skipped ({e})")


class BuildExt(OptionalBuildExt):
    """``OptionalBuildExt``, then the PyTorch port's prebuilt libraries."""

    def run(self):  # noqa: D102
        super().run()
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiktoken_tpu_torch",
                            "_build.py")
        spec = importlib.util.spec_from_file_location("tiktoken_tpu_torch_build", path)
        build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build)
        out = (build.PREBUILT_DIR if self.inplace
               else os.path.join(self.build_lib, "tiktoken_tpu_torch", "prebuilt"))
        try:
            written = build.build_prebuilt(out)
        except Exception as e:  # pragma: no cover - toolchain-dependent
            self.warn(f"the PyTorch port's prebuilt libraries skipped ({e})")
            return
        self.announce(f"the PyTorch port's prebuilt libraries: {written}", level=2)


setup(
    ext_modules=[
        Extension(
            "tiktoken_tpu.native._ttpu_core",
            sources=["tiktoken_tpu/native/core.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-fPIC", "-pthread"]
            + (["-msse4.2"] if platform.machine() in ("x86_64", "AMD64")
               else []),
            extra_link_args=["-pthread"],
            optional=True,
        )
    ],
    cmdclass={"build_ext": BuildExt},
)

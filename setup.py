"""Packaging for paddle_tpu (reference L0: CMake tree + setup.py — here
the native pieces build through one Makefile into a single ctypes .so
shipped inside the wheel as package data)."""

import subprocess
import sys
from pathlib import Path

from setuptools import Command, Distribution, find_packages, setup
from setuptools.command.build_py import build_py


class BinaryDistribution(Distribution):
    """The bundled ctypes .so is arch-specific (-march=native): force a
    platform wheel tag so a build never installs cross-arch."""

    def has_ext_modules(self):
        return True

ROOT = Path(__file__).parent


def _build_native() -> None:
    csrc = ROOT / "paddle_tpu" / "csrc"
    subprocess.run(["make", "-s"], cwd=csrc, check=True)


class BuildPy(build_py):
    def run(self):
        try:
            _build_native()
        except Exception as e:  # toolchain-less install: python fallbacks
            print(f"warning: native build skipped ({e})", file=sys.stderr)
        super().run()


class BuildNative(Command):
    """`python setup.py build_native` — just the .so."""

    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        _build_native()


setup(
    name="paddle_tpu",
    version="0.2.0",
    description=("TPU-native distributed training framework: "
                 "parameter-server sparse training (CTR), hybrid "
                 "dp/tp/pp/cp/ep parallelism, compiled train steps over "
                 "JAX/XLA/Pallas with a C++ host runtime"),
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                   "paddle_tpu_torch", "paddle_tpu_torch.*"]),
    package_data={"paddle_tpu": ["csrc/*.cc", "csrc/*.h", "csrc/Makefile",
                                 "csrc/*.so"],
                  "paddle_tpu_torch": ["csrc/*.cc", "ops/csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    cmdclass={"build_py": BuildPy, "build_native": BuildNative},
    distclass=BinaryDistribution,
)

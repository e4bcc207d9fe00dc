"""Packaging (ref: the reference's setup.py builds CUDA/Cython extensions;
here the only native piece is the optional C++ host-ops library built via
``make -C csrc`` — the device kernels are XLA/Pallas, nothing to compile)."""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


def get_version():
    ns = {}
    with open(os.path.join("ioudet", "version.py")) as f:
        exec(f.read(), ns)
    return ns["__version__"]


class BuildWithNative(build_py):
    def run(self):
        try:
            subprocess.run(["make", "-C", "csrc"], check=True)
        except Exception as e:  # noqa: BLE001 — native lib is optional
            print(f"warning: native host-ops build skipped ({e})")
        super().run()


setup(
    name="ioudet",
    version=get_version(),
    description="TPU-native IoU-aware single-stage object detection framework",
    packages=find_packages(exclude=("tests", "tools", "configs", "csrc")),
    package_data={"ioudet": ["_native/*.so"], "ioudet_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "Pillow"],
    cmdclass={"build_py": BuildWithNative},
)

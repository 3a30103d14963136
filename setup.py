"""Packaging (reference parity: the reference ships a pip setup.py).

The native C++ helper library builds lazily at first import via g++
(fenicssolver_tpu/native.py); no extension module is required at install
time, so this stays a pure-python distribution with a bundled source file.
"""

from setuptools import find_packages, setup

setup(
    name="fenicssolver-tpu",
    version="0.1.0",
    description=(
        "TPU-native multiphysics FEM framework (JAX/XLA/Pallas): scalar "
        "transport, incompressible Navier-Stokes, linear/hyperelastic/"
        "large-deformation elasticity, FSI — a from-scratch rebuild of the "
        "capabilities of qingfengxia/FenicsSolver"
    ),
    license="LGPL-2.1",
    packages=find_packages(
        include=[
            "fenicssolver_tpu",
            "fenicssolver_tpu.*",
            "fenicssolver_tpu_torch",
            "fenicssolver_tpu_torch.*",
        ]
    ),
    package_data={
        "": ["../native/fst_native.cpp"],
        "fenicssolver_tpu_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
    extras_require={"io": ["h5py"], "plot": ["matplotlib"]},
    entry_points={
        "console_scripts": [
            "fenicssolver-tpu=fenicssolver_tpu.main:main",
        ]
    },
)

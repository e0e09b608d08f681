#!/usr/bin/env python3
"""Packaging for stringdecomposer-tpu.

Mirrors the reference's install surface (console script + packaged model and
test data, reference: setup.py:46-73) without its custom make hook — the
native host library (runtime/native) builds itself on first use and has pure
NumPy fallbacks.
"""

from setuptools import find_packages, setup

setup(
    name="stringdecomposer-tpu",
    version="0.1.0",
    description="TPU-native monomer string decomposition (JAX/Pallas)",
    # the JAX reference and its PyTorch / CUDA port (kernels build from
    # csrc/ with nvcc at first use; torch is the "torch" extra)
    packages=find_packages(include=[
        "stringdecomposer_tpu", "stringdecomposer_tpu.*",
        "stringdecomposer_tpu_torch", "stringdecomposer_tpu_torch.*",
    ]),
    package_data={
        "stringdecomposer_tpu": [
            "models/*.txt",
            "test_data/*",
            "runtime/native/*.cpp",
            "runtime/native/Makefile",
        ],
        "stringdecomposer_tpu_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "stringdecomposer-tpu = stringdecomposer_tpu.cli:main",
            "stringdecomposer-tpu-torch = stringdecomposer_tpu_torch.cli:main",
        ]
    },
)

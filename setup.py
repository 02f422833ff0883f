"""Package install script (the reference ships as the installable
``ppvector`` package via its own setup.py)."""

import os

from setuptools import find_packages, setup


def _version():
    init = os.path.join(os.path.dirname(__file__),
                        "voiceprintrecognition_paddlepaddle_tpu",
                        "__init__.py")
    with open(init, encoding="utf-8") as f:
        for line in f:
            if line.startswith("__version__"):
                return line.split('"')[1]
    return "0.0.0"


setup(
    name="voiceprintrecognition-paddlepaddle-tpu",
    version=_version(),
    description="TPU-native (JAX/XLA/Pallas) speaker-verification framework",
    packages=find_packages(include=["voiceprintrecognition_paddlepaddle_tpu*",
                                    "voiceprintrecognition_paddlepaddle_torch*"]),
    package_data={
        "voiceprintrecognition_paddlepaddle_tpu.native": ["*.cpp"],
        # the PyTorch port's CUDA sources, built by nvcc at first use
        # and the configs of its own backbones
        "voiceprintrecognition_paddlepaddle_torch": ["csrc/*.cu", "configs/*.yml"],
        # and its C++ audio I/O source, built by g++ at first use
        "voiceprintrecognition_paddlepaddle_torch.native": ["*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy", "scipy", "pyyaml",
        "scikit-learn", "tensorboardX",
    ],
    extras_require={
        # the PyTorch/CUDA port (voiceprintrecognition_paddlepaddle_torch)
        "torch": ["torch", "numpy", "scipy"],
    },
)

"""PyTorch/CUDA port of the speaker-verification framework.

A second package beside ``voiceprintrecognition_paddlepaddle_tpu`` (the
JAX reference). It imports ``torch`` and never ``jax``. This first slice
serves the CAM++ embedding through ``predict.Predictor``: a hand-written
CUDA fbank kernel, plain PyTorch FCM convolutions, and a hand-written
CUDA kernel for the whole CAM++ trunk (``csrc/``).
"""

__version__ = "0.1.0"

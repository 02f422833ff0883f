"""PyTorch/CUDA port of the speaker-verification framework.

A second package beside ``voiceprintrecognition_paddlepaddle_tpu`` (the
JAX reference). It imports ``torch`` and never ``jax``. It serves the
CAM++ embedding through ``predict.Predictor`` with hand-written CUDA
kernels (``csrc/``) for the fbank, the FCM front end (buckets of 1000
frames and more; plain PyTorch convs below) and the whole CAM++ trunk,
up to the 32 s bucket; longer buckets run the plain model.
"""

__version__ = "0.1.0"

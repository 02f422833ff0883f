"""Plain reference of the benchmark: Kaldi's fbank and CMN, CAM++ and
ERes2Net as plain PyTorch in fp32, and the CAM++ train step. It imports
nothing of the port or of the JAX package, and works out from the seeded
state dict everything the port derives from it (folded BatchNorms,
packed weights)."""

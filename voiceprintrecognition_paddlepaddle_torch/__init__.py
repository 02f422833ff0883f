"""PyTorch/CUDA port of the speaker-verification framework.

A second package beside ``voiceprintrecognition_paddlepaddle_tpu`` (the
JAX reference). It imports ``torch`` and never ``jax``. It serves the
CAM++ embedding through ``predict.Predictor`` with hand-written CUDA
kernels (``csrc/``) for the fbank, the FCM front end (buckets of 1000
frames and more; plain PyTorch convs below) and the whole CAM++ trunk,
up to the 32 s bucket; longer buckets run the plain model.

Entry points, each ``python -m voiceprintrecognition_paddlepaddle_torch.<name>``;
those that embed or train run on ``cuda`` unless given ``--device=cpu``:

- training and evaluation: ``train``, ``eval``, ``eval_from_paddle``,
  ``launch_multihost`` (N processes of one of these);
- data and checkpoints: ``create_data``, ``extract_features``,
  ``convert_paddle``;
- inference: ``infer_contrast``, ``infer_recognition``,
  ``infer_speaker_diarization`` (``--show_plot`` needs matplotlib),
  ``serve``;
- the tk GUIs (a display needed): ``infer_contrast_gui``,
  ``infer_recognition_gui``, ``infer_speaker_diarization_gui``;
- diarization evaluation: ``eval_speaker_diarization.create_aishell4_test_rttm``,
  ``eval_speaker_diarization.infer_data``,
  ``eval_speaker_diarization.compute_metrics``.
"""

__version__ = "0.1.0"

"""Speaker-diarization evaluation on AIShell-4 with the port (counterpart
of the JAX package's ``tools/eval_speaker_diarization/``; README.md in
this directory gives the commands).

- ``create_aishell4_test_rttm``: merge the per-file reference RTTMs, list
  the test audio, cut per-speaker enrollment audio into a per-file
  audio_db;
- ``infer_data``: diarize each listed file, naming speakers from its
  audio_db, into a hypothesis RTTM;
- ``compute_metrics``: DER, false alarm, confusion and missed detection of
  the hypotheses against the references (``infer_utils/der.py``).
"""

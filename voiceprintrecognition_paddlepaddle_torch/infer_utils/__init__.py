from .speaker_diarization import SpeakerDiarization, SpectralCluster

__all__ = ["SpeakerDiarization", "SpectralCluster"]

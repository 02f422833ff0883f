from .collate import collate_features, collate_waveforms
from .loader import DataLoader
from .pk_sampler import BatchSampler, PKSampler
from .reader import SpeakerDataset

__all__ = ["SpeakerDataset", "DataLoader", "PKSampler", "BatchSampler",
           "collate_features", "collate_waveforms"]

from .metrics import compute_fnr_fpr, compute_eer, compute_dcf

__all__ = ["compute_fnr_fpr", "compute_eer", "compute_dcf"]

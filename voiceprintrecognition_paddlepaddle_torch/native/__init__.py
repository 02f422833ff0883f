from .audio_native import (decode_wav_native, load_batch_native,
                           native_library, resample_native, rms_db_native)

__all__ = ["decode_wav_native", "resample_native", "rms_db_native",
           "load_batch_native", "native_library"]

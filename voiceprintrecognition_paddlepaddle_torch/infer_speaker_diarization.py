"""Speaker diarization of a long recording with the port's Predictor
(counterpart of the root ``infer_speaker_diarization.py``).

``--show_plot=True`` draws the timeline into
``output/speaker_diarization.png`` (``infer_utils/viewer.PlotSpeaker``),
which needs matplotlib: without it the command raises ``ImportError``
after printing the results.

Run: python -m voiceprintrecognition_paddlepaddle_torch.infer_speaker_diarization
--configs=configs/cam++.yml --model_path=<model.pt> [--device=cuda]
[--audio_path=dataset/test_long.wav] [--search_audio_db=True]
[--show_plot=True]
"""

import argparse
import functools

from .predict import Predictor
from .utils.utils import add_arguments, print_arguments


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",     str,  "configs/cam++.yml", "config file path")
    add_arg("device",      str,  "cuda", "torch device: cuda or cpu")
    add_arg("audio_path",  str,  "dataset/test_long.wav", "audio to diarize")
    add_arg("audio_db_path", str, "audio_db/",
            "voiceprint db (for naming speakers)")
    add_arg("speaker_num", int,  None, "oracle speaker count (optional)")
    add_arg("search_audio_db", bool, False,
            "name speakers by searching the voiceprint database")
    add_arg("show_plot",   bool, False, "render the diarization timeline")
    add_arg("threshold",   float, 0.6,
            "same-speaker decision threshold for audio-db matching")
    add_arg("model_path",  str,  "models/CAMPPlus_Fbank/best_model/",
            "model.pt or its directory")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    predictor = Predictor(
        configs=args.configs, model_path=args.model_path, device=args.device,
        threshold=args.threshold,
        audio_db_path=args.audio_db_path if args.search_audio_db else None)
    results = predictor.speaker_diarization(
        args.audio_path, speaker_num=args.speaker_num,
        search_audio_db=args.search_audio_db)
    print("diarization results:")
    for result in results:
        print(result)
    if args.show_plot:
        from .infer_utils.viewer import PlotSpeaker
        PlotSpeaker(results, audio_path=args.audio_path).draw(
            "output/speaker_diarization.png")
    return results


if __name__ == "__main__":
    main()

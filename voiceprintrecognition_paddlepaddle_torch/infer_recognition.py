"""1:N voiceprint recognition over a persistent audio database with the
port's Predictor (counterpart of the root ``infer_recognition.py``).

With ``--register NAME=PATH`` or ``--recognize PATH`` (each may repeat) it
registers and then recognises those files and exits. Without them it is
the reference's loop: record from the microphone (``utils/record.py``,
which needs the ``soundcard`` package), register, recognise, remove a
user, list the users.

Run: python -m voiceprintrecognition_paddlepaddle_torch.infer_recognition
--configs=configs/cam++.yml --model_path=<model.pt> [--device=cuda]
[--audio_db_path=audio_db/] [--register alice=a.wav] [--recognize c.wav]
"""

import argparse
import functools

from .predict import Predictor
from .utils.record import RecordAudio
from .utils.utils import add_arguments, print_arguments


def _recognize(predictor, audio, sample_rate=16000):
    name, score = predictor.recognition(audio, sample_rate=sample_rate)
    if name:
        print(f"recognised speaker: {name}, similarity: {score}")
    else:
        print("no matching user in the database")
    return name, score


def _loop(predictor, record_seconds):
    record_audio = RecordAudio()
    while True:
        select_fun = int(input("select action: 0=register, 1=recognise, "
                               "2=remove user, 3=list users, 4=quit: "))
        if select_fun == 0:
            audio = record_audio.record(record_seconds=record_seconds)
            name = input("enter user name for registration: ")
            if name:
                predictor.register(audio, user_name=name,
                                   sample_rate=record_audio.sample_rate)
        elif select_fun == 1:
            audio = record_audio.record(record_seconds=record_seconds)
            _recognize(predictor, audio, record_audio.sample_rate)
        elif select_fun == 2:
            name = input("enter user name to remove: ")
            if name:
                predictor.remove_user(user_name=name)
        elif select_fun == 3:
            print("registered users:", predictor.get_users())
        else:
            break


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",        str,   "configs/cam++.yml", "config file path")
    add_arg("device",         str,   "cuda", "torch device: cuda or cpu")
    add_arg("audio_db_path",  str,   "audio_db/", "voiceprint database directory")
    add_arg("record_seconds", int,   3,    "seconds to record per utterance")
    add_arg("threshold",      float, 0.6,  "recognition threshold")
    add_arg("model_path",     str,   "models/CAMPPlus_Fbank/best_model/",
            "model.pt or its directory")
    parser.add_argument("--register", action="append", default=[],
                        metavar="NAME=PATH",
                        help="register the user NAME from the audio file PATH")
    parser.add_argument("--recognize", action="append", default=[],
                        metavar="PATH",
                        help="recognise the speaker of the audio file PATH")
    args = parser.parse_args(argv)
    print_arguments(args=args)
    register = []
    for item in args.register:
        name, sep, path = item.partition("=")
        if not (sep and name and path):
            parser.error(f"--register takes NAME=PATH, got {item!r}")
        register.append((name, path))

    predictor = Predictor(configs=args.configs, model_path=args.model_path,
                          threshold=args.threshold,
                          audio_db_path=args.audio_db_path,
                          device=args.device)
    if not (register or args.recognize):
        _loop(predictor, args.record_seconds)
        return None
    for name, path in register:
        ok, msg = predictor.register(path, user_name=name)
        print(f"register {name} from {path}: {ok} {msg}")
    results = [(path, *_recognize(predictor, path))
               for path in args.recognize]
    print("registered users:", predictor.get_users())
    return results


if __name__ == "__main__":
    main()

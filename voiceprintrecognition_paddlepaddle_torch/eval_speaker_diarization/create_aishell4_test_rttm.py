"""Prepare AIShell-4 test references: merge per-file RTTMs, list the test
audio, and cut per-speaker enrollment audio into a per-file audio_db
(counterpart of the JAX package's
``tools/eval_speaker_diarization/create_aishell4_test_rttm.py``).

Run: python -m voiceprintrecognition_paddlepaddle_torch.eval_speaker_diarization.create_aishell4_test_rttm
[--annotation_dir=dataset/test/TextGrid] [--audio_dir=dataset/test/wav]
[--rttm_path=dataset/references.rttm] [--list_path=dataset/data_list.txt]
[--audio_db_dir=dataset/audio_db/]
"""

import argparse
import os

from ..infer_utils.der import load_rttm
from ..ops.audio import AudioSegment


def create_rttm(annotation_dir, output_path):
    with open(output_path, "w", encoding="utf-8") as out:
        for file in sorted(os.listdir(annotation_dir)):
            if not file.endswith(".rttm"):
                continue
            with open(os.path.join(annotation_dir, file), "r",
                      encoding="utf-8") as f:
                out.write(f.read())


def create_audio_path_list(audio_dir, list_path):
    with open(list_path, "w", encoding="utf-8") as out:
        for file in sorted(os.listdir(audio_dir)):
            if not file.endswith((".flac", ".wav")):
                continue
            path = os.path.join(audio_dir, file).replace("\\", "/")
            out.write(f"{path}\t{file.rsplit('.', 1)[0]}\n")


def create_audio_db(data_list_path, rttm_path, output_dir):
    annotations = load_rttm(rttm_path)
    with open(data_list_path, "r", encoding="utf-8") as f:
        for line in f:
            audio_path, name = line.strip().split("\t")
            seg = AudioSegment.from_file(audio_path)
            sr, audio = seg.sample_rate, seg.samples
            for track, (start, end, label) in enumerate(
                    annotations.get(name, [])):
                if end - start < 0.3:
                    continue
                save_path = os.path.join(output_dir, name, label,
                                         f"{track}.wav")
                os.makedirs(os.path.dirname(save_path), exist_ok=True)
                AudioSegment(audio[int(start * sr):int(end * sr)],
                             sr).to_wav_file(save_path)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--annotation_dir", default="dataset/test/TextGrid",
                        help="directory of per-file reference RTTMs")
    parser.add_argument("--audio_dir", default="dataset/test/wav",
                        help="directory of the test audio")
    parser.add_argument("--rttm_path", default="dataset/references.rttm",
                        help="merged reference RTTM to write")
    parser.add_argument("--list_path", default="dataset/data_list.txt",
                        help="test audio list to write")
    parser.add_argument("--audio_db_dir", default="dataset/audio_db/",
                        help="per-file audio_db root to write")
    args = parser.parse_args(argv)
    create_rttm(annotation_dir=args.annotation_dir,
                output_path=args.rttm_path)
    create_audio_path_list(audio_dir=args.audio_dir,
                           list_path=args.list_path)
    create_audio_db(data_list_path=args.list_path, rttm_path=args.rttm_path,
                    output_dir=args.audio_db_dir)


if __name__ == "__main__":
    main()

"""Write the train list of CN-Celeb (+ CN-Celeb2) (counterpart of the root
``create_data.py``): CN-Celeb speakers with id < 800 go to the train list,
CN-Celeb2 labels are offset by 800; one ``path\\tlabel`` line per file.

Run: python -m voiceprintrecognition_paddlepaddle_torch.create_data
[--cn_celeb_dir=dataset/CN-Celeb_flac/data]
[--cn_celeb2_dir=dataset/CN-Celeb2_flac/data]
[--list_path=dataset/train_list.txt]
"""

import argparse
import functools
import os

from .utils.utils import add_arguments, print_arguments

N_CNCELEB_TRAIN = 800  # CN-Celeb speakers past this id are the test split


def create_list(cn_celeb_dir, cn_celeb2_dir, list_path):
    """Write ``list_path``; returns its lines."""
    os.makedirs(os.path.dirname(list_path) or ".", exist_ok=True)
    lines = []
    for root, offset, limit in ((cn_celeb_dir, 0, N_CNCELEB_TRAIN),
                                (cn_celeb2_dir, N_CNCELEB_TRAIN, None)):
        if not os.path.isdir(root):
            continue
        for spk_id, speaker in enumerate(sorted(os.listdir(root))):
            if limit is not None and spk_id >= limit:
                continue
            spk_dir = os.path.join(root, speaker)
            for name in sorted(os.listdir(spk_dir)):
                path = os.path.join(spk_dir, name).replace("\\", "/")
                lines.append(f"{path}\t{spk_id + offset}")
    with open(list_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} entries to {list_path}")
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("cn_celeb_dir",  str, "dataset/CN-Celeb_flac/data",
            "CN-Celeb data dir")
    add_arg("cn_celeb2_dir", str, "dataset/CN-Celeb2_flac/data",
            "CN-Celeb2 data dir")
    add_arg("list_path",     str, "dataset/train_list.txt", "output list path")
    args = parser.parse_args(argv)
    print_arguments(args=args)
    return create_list(args.cn_celeb_dir, args.cn_celeb2_dir, args.list_path)


if __name__ == "__main__":
    main()

"""``python -m icee_tpu_torch.cli.build_vocab`` — reference-compatible
vocabulary CLI (``stylenet/build_vocab.py:64-88``; port of
``icee_tpu/cli/build_vocab.py``): same flags, same pickle output, which
both packages load."""

import argparse
import pickle

from icee_tpu_torch.data.vocab import build_vocab


def main(args) -> None:
    vocab = build_vocab(path=args.caption_path, threshold=args.threshold)
    with open(args.vocab_path, "wb") as f:
        pickle.dump(vocab, f)
    print("Total vocabulary size: {}".format(len(vocab)))
    print("Saved the vocabulary wrapper to '{}'".format(args.vocab_path))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--caption_path", type=str,
                   default="data/flickr8k/train.txt",
                   help="path for train annotation file")
    p.add_argument("--vocab_path", type=str,
                   default="./data/flickr8k/vocab.pkl",
                   help="path for saving vocabulary wrapper")
    p.add_argument("--threshold", type=int, default=4,
                   help="minimum word count threshold")
    return p


if __name__ == "__main__":
    main(parser().parse_args())

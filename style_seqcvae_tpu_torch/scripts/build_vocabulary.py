"""Build the caption vocabulary (counterpart of the repository's
``scripts/build_vocabulary.py``): COCO words counted at least
``--word-count-threshold`` times plus Senticap words counted at least
``--senticap-word-count-threshold`` times together, the special tokens
first, written in the AllenNLP file format by ``data/vocabulary.py``.

    python -m style_seqcvae_tpu_torch.scripts.build_vocabulary \\
        -c captions_train.json [-s senticap_dataset.json] -o vocabulary/
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from style_seqcvae_tpu_torch.data.vocabulary import Vocabulary, build_caption_vocabulary

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("-c", "--captions-jsonpath", required=True)
parser.add_argument("-s", "--senticap-jsonpath", default="")
parser.add_argument("-t", "--word-count-threshold", type=int, default=5)
parser.add_argument("-st", "--senticap-word-count-threshold", type=int, default=2)
parser.add_argument("-o", "--output-dirpath", required=True)


def main(argv: Optional[List[str]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code."""
    args = parser.parse_args(argv)
    with open(args.captions_jsonpath) as f:
        captions = json.load(f)["annotations"]
    senticap = []
    if args.senticap_jsonpath:
        with open(args.senticap_jsonpath) as f:
            senticap = json.load(f)["images"]
    tokens = build_caption_vocabulary(captions, senticap, args.word_count_threshold,
                                      args.senticap_word_count_threshold)
    print(f"Caption vocabulary size (with special tokens): {len(tokens)}")
    Vocabulary(tokens).save_to_files(args.output_dirpath)
    print(f"Wrote vocabulary to {args.output_dirpath}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

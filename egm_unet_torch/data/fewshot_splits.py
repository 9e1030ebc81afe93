"""Few-shot / zero-shot class-split utilities (port of
``egm_unet_tpu/data/fewshot_splits.py``).

The reference's ``datasets/coco_wrapper.py`` / ``pascal_zeroshot.py`` /
``pfe_dataset.py`` depend on missing third-party repos (hsnet/JoEm/PFENet;
SURVEY.md §2.19 — not runnable).  This module implements the *contract* those
wrappers encode natively:

- Pascal-5i folds: 20 classes split into 4 folds of 5 (standard OSLSM split);
- COCO-20i folds: 80 classes split into 4 interleaved folds of 20 (standard
  HSNet convention: fold i takes classes {i, i+4, i+8, ...});
- Pascal zero-shot unseen sets (ref: datasets/pascal_zeroshot.py:9-12 —
  2/4/6/8/10 unseen classes accumulate the listed pairs);
- WordNet-style synonym filtering used by PhraseCut's pascal-test split
  (phrases containing a held-out class name are removed from training,
  ref: datasets/phrasecut.py:164-228) — implemented as plain substring
  matching against class synonym lists.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

PASCAL_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

# ref: datasets/pascal_zeroshot.py:9-12 (wordnet ids -> class names)
PASCAL_ZEROSHOT_PAIRS = (
    ("cow", "motorbike"),
    ("aeroplane", "sofa"),
    ("cat", "tvmonitor"),
    ("train", "bottle"),
    ("chair", "pottedplant"),
)

# a small synonym table for prompt filtering (extend as needed)
CLASS_SYNONYMS = {
    "aeroplane": ["aeroplane", "airplane", "plane", "aircraft", "jet"],
    "bicycle": ["bicycle", "bike", "cycle"],
    "bird": ["bird"],
    "boat": ["boat", "ship", "vessel"],
    "bottle": ["bottle"],
    "bus": ["bus"],
    "car": ["car", "automobile"],
    "cat": ["cat", "kitten"],
    "chair": ["chair"],
    "cow": ["cow", "cattle", "bull"],
    "diningtable": ["diningtable", "dining table", "table"],
    "dog": ["dog", "puppy"],
    "horse": ["horse", "pony"],
    "motorbike": ["motorbike", "motorcycle"],
    "person": ["person", "man", "woman", "people", "human"],
    "pottedplant": ["pottedplant", "potted plant", "pot plant", "plant"],
    "sheep": ["sheep", "lamb"],
    "sofa": ["sofa", "couch"],
    "train": ["train", "locomotive"],
    "tvmonitor": ["tvmonitor", "tv", "television", "monitor"],
}


def pascal_5i_fold(fold: int, split: str = "val") -> Tuple[List[str], List[str]]:
    """(novel_classes, base_classes) for Pascal-5i fold in 0..3: fold i's
    novel classes are indices [5i, 5i+5)."""
    assert 0 <= fold < 4
    novel = list(PASCAL_CLASSES[5 * fold : 5 * fold + 5])
    base = [c for c in PASCAL_CLASSES if c not in novel]
    return novel, base


def coco_20i_fold(fold: int, num_classes: int = 80) -> Tuple[List[int], List[int]]:
    """(novel_ids, base_ids) — HSNet interleaved convention:
    fold i holds class ids {i, i+4, i+8, ...}."""
    assert 0 <= fold < 4
    novel = [c for c in range(num_classes) if c % 4 == fold]
    base = [c for c in range(num_classes) if c % 4 != fold]
    return novel, base


def pascal_zeroshot_unseen(n_unseen: int) -> List[str]:
    """Unseen class set for n_unseen in {2,4,6,8,10}: the first n/2 pairs
    (ref: datasets/pascal_zeroshot.py:9-12 accumulation)."""
    assert n_unseen in (2, 4, 6, 8, 10)
    out: List[str] = []
    for pair in PASCAL_ZEROSHOT_PAIRS[: n_unseen // 2]:
        out.extend(pair)
    return out


def phrase_mentions_class(phrase: str, class_name: str) -> bool:
    p = phrase.lower()
    return any(syn in p for syn in CLASS_SYNONYMS.get(class_name, [class_name]))


def filter_phrases_for_split(phrases: Sequence[str], held_out: Sequence[str],
                             remove_classes: bool = True) -> List[str]:
    """PhraseCut pascal-test-style filtering: drop (or keep only) phrases
    that mention held-out classes (ref: datasets/phrasecut.py:164-228)."""
    def mentions_any(phrase):
        return any(phrase_mentions_class(phrase, c) for c in held_out)

    if remove_classes:
        return [p for p in phrases if not mentions_any(p)]
    return [p for p in phrases if mentions_any(p)]

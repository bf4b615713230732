"""Dataset substrate: ``Datum`` records, split bookkeeping, few-shot
subsets (the port's own copy of transductive_clip_tpu/data/base.py;
reference: src/datasets/utils.py:46-235).

The reference's ``DatasetBase`` carries unlabeled/domain splits and
download helpers that nothing in the protocol uses; here the base keeps
only what the evaluators consume: the three splits, the prompt template,
and the label->classname map.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass


@dataclass(frozen=True)
class Datum:
    """One image record (reference: src/datasets/utils.py:46-85)."""

    impath: str
    label: int
    classname: str


class DatasetBase:
    """Split bookkeeping + label->classname map derived from the data
    (reference: src/datasets/utils.py:87-158)."""

    def __init__(self, train_x=None, val=None, test=None, template=""):
        self.train_x = list(train_x or [])
        self.val = list(val or [])
        self.test = list(test or [])
        self.template = template

        lab2cname = {}
        for d in (*self.train_x, *self.val, *self.test):
            lab2cname.setdefault(int(d.label), d.classname)
        self.lab2cname = {k: lab2cname[k] for k in sorted(lab2cname)}
        # ordered by label id, like the reference's get_lab2cname
        self.classnames = list(self.lab2cname.values())
        self.num_classes = max(lab2cname, default=-1) + 1


def generate_fewshot_subset(data, num_shots, rng):
    """``num_shots`` samples per class; classes with fewer items than
    ``num_shots`` are sampled with replacement
    (reference: src/datasets/utils.py:193-235).

    ``num_shots < 1`` returns the data unchanged — the reference's
    'use all data' sentinel (default -1, src/datasets/utils.py:207-208).
    """
    if num_shots < 1:
        return list(data)
    by_label = defaultdict(list)
    for d in data:
        by_label[int(d.label)].append(d)
    out = []
    for label in sorted(by_label):
        items = by_label[label]
        idx = rng.choice(
            len(items), size=num_shots, replace=len(items) < num_shots
        )
        out.extend(items[i] for i in idx)
    return out
